"""The convolutions' share of their roofline in the traced train steps: the
least time the step's convolution work needs (``flops.train_step``) over
the device time of the kernels that the family table classes as
convolution, in percent; nothing where no such kernel ran."""


def read(records):
    if records.get("kind") != "train" or not records.get("peak"):
        return None
    conv_s = records["trace"]["conv_s"]
    if conv_s <= 0:
        return None
    least = records["conv_least_s_per_step"] * records["traced_steps"]
    return 100.0 * least / conv_s
