"""AdaLIN and ILN's share of their roofline in the traced train steps: the
least time of the step's AdaLIN and ILN passes (their bytes read once and
written once over the card's bandwidth, ``drivers/ugatit_train.py``
``step_work``) over the device time of the kernel family ``ada_norm``
(K14 and K15), in percent; nothing where the run counted no such pass or
no such kernel ran."""


def read(records):
    if records.get("kind") != "train" or not records.get(
            "adalin_least_s_per_step"):
        return None
    device_s = records["trace"]["families"].get("ada_norm", 0.0)
    if device_s <= 0:
        return None
    least = records["adalin_least_s_per_step"] * records["traced_steps"]
    return 100.0 * least / device_s
