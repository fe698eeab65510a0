"""The paper's AvgMaxVio over the traced steps: the mean over steps of the
largest MaxVio of any MoE layer (load_max / (k n / m) - 1, from the step's
expert loads before capacity), as the program's step metrics report it."""


def read(rec):
    vios = rec.get("max_vio")
    return sum(float(v.max()) for v in vios) / len(vios) if vios else None
