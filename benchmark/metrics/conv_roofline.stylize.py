"""The convolutions' share of their roofline in the traced stylize calls:
the least time of the generator forward's convolutions
(``flops.generator_forward``) over the device time of the kernels that the
family table classes as convolution, in percent; nothing where no such
kernel ran."""


def read(records):
    if records.get("kind") != "stylize" or not records.get("peak"):
        return None
    conv_s = records["trace"]["conv_s"]
    if conv_s <= 0:
        return None
    least = records["conv_least_s_per_call"] * records["traced_calls"]
    return 100.0 * least / conv_s
