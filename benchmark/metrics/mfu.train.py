"""Model FLOP utilisation of the train step: the convolutions' operations of
the steps in the unprofiled window (``flops.train_step``: six generator
and four discriminator applications, forward, dX and dW), over its
seconds, over the card's dense peak in the compute dtype, in percent."""


def read(records):
    if records.get("kind") != "train" or not records.get("peak"):
        return None
    rate = records["ops_per_step"] * records["steps"] / records["window_s"]
    return 100.0 * rate / records["peak"]["flops"][records["dtype"]]
