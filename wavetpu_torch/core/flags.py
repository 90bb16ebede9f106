"""One `--flag[=value]` argv parser (the port's copy of wavetpu/core/flags.py).

The port's CLI speaks wavetpu's flag dialect (`--flag value`,
`--flag=value`, valueless switches, reference-style positionals), with the
same error wording and edge cases (`--flag` at end of argv, unknown flags
as loud usage errors instead of silent drops).

Imports nothing (same before-the-backend discipline as core.problem).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple


def split_flags(
    argv: Sequence[str],
    known: Sequence[str],
    valueless: Sequence[str] = (),
    allow_positionals: bool = True,
    repeatable: Sequence[str] = (),
) -> Tuple[List[str], Dict[str, object]]:
    """Separate positionals from --flag[=value] options.

    Raises ValueError for unknown flags, a flag missing its value, or
    (with `allow_positionals=False`) any positional - so typos surface
    as the caller's usage error instead of being silently ignored.

    A repeated flag is last-wins (the shell-override idiom) UNLESS it
    is listed in `repeatable`, in which case its value is a LIST of
    every occurrence in argv order (the multi-replica `--target` /
    `--backend` dialect of loadgen and the fleet router)."""
    pos: List[str] = []
    flags: Dict[str, object] = {}
    it = iter(argv)
    for a in it:
        if a.startswith("--"):
            if "=" in a:
                k, v = a[2:].split("=", 1)
            else:
                k = a[2:]
                if k in valueless:
                    v = ""
                else:
                    v = next(it, None)
                    if v is None:
                        raise ValueError(f"flag --{k} needs a value")
            if k not in known:
                raise ValueError(f"unknown flag --{k}")
            if k in repeatable:
                flags.setdefault(k, []).append(v)
            else:
                flags[k] = v
        else:
            if not allow_positionals:
                raise ValueError(f"unexpected positional {a!r}")
            pos.append(a)
    return pos, flags
