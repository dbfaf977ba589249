"""Mean seconds of ``insert_bulk`` per build in the window (the
benchmark's own span around the call, device drained at its end)."""


def read(rec):
    b = rec.get("builds")
    return sum(x["insert_bulk_s"] for x in b) / len(b) if b else None
