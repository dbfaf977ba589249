"""setup_s: seconds from the process's start to the measured window
(loading, data, build, finalize, warm-up)."""


def read(rec):
    return rec.get("setup_s")
