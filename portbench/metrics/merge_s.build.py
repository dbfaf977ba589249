"""Device-clock seconds of the cluster build's ``hnsw.build.merge`` phase per
traced build, summed over the layers."""

from portbench.lib.spans import phase_s


def read(rec):
    return phase_s(rec, "merge")
