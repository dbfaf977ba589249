"""build_vec_per_s: points indexed by the window's whole builds over the
window's seconds (host clock; the build in flight at the end counted)."""


def read(rec):
    if "points_built" not in rec:
        return None
    return rec["points_built"] / rec["window_s"]
