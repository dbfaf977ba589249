"""recall_at_10: mean |ids & exact top-10| / 10 over every answer judged
(the judge's number, against the reference in the stored 8-bit space)."""


def read(rec):
    return rec["judge"]["recall_at_10"] if "judge" in rec else None
