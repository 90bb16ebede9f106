"""serve.lanes_per_batch: answered requests in a serving window over the
batches the replica executed in it (the program's `serve.execute` spans,
one per batch); None without the span records."""


def read(rec):
    execute = (rec.get("spans") or {}).get("serve.execute")
    if not execute or not execute["count"]:
        return None
    return rec["answers"] / execute["count"]
