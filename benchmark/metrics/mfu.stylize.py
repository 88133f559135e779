"""Model FLOP utilisation of stylization: the generator forward's
convolution operations (``flops.generator_forward``) of the batches
stylized in the unprofiled window, over its seconds, over the card's
dense peak in the compute dtype, in percent."""


def read(records):
    if records.get("kind") != "stylize" or not records.get("peak"):
        return None
    rate = records["ops_per_call"] * records["calls"] / records["window_s"]
    return 100.0 * rate / records["peak"]["flops"][records["dtype"]]
