"""serve.host_ms_per_request: the replica's host time around each request
in a serving window, the program's `serve.parse` (body read, JSON decode,
validation) and `serve.respond` (payload, JSON, send) spans summed over
the window and divided by the answered requests.  From the program's span
records (the handler threads' spans do not reach a profiler started on
the benchmark's thread); None without them."""


def read(rec):
    spans = rec.get("spans") or {}
    parse, respond = spans.get("serve.parse"), spans.get("serve.respond")
    if not parse or not respond or not rec.get("answers"):
        return None
    return 1e3 * (parse["host_s"] + respond["host_s"]) / rec["answers"]
