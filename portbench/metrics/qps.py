"""qps: queries answered in the window over the window's seconds (host
clock; every call of the window, the last one finished)."""


def read(rec):
    if "queries_answered" not in rec:
        return None
    return rec["queries_answered"] / rec["window_s"]
