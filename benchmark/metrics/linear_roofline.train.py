"""The Linear layers' and power iterations' share of their roofline in the
traced train steps: the least time of every Linear pass (forward, input
and weight gradients) and of the power iterations' matrix-vector
products, each max(operations / peak, bytes / bandwidth)
(``drivers/ugatit_train.py`` ``step_work``), over the device time of the
kernel family ``library_gemm`` (cuBLAS GEMM and GEMV kernels), in
percent; nothing where the run counted no such pass or no such kernel
ran."""


def read(records):
    if records.get("kind") != "train" or not records.get(
            "linear_least_s_per_step"):
        return None
    device_s = records["trace"]["families"].get("library_gemm", 0.0)
    if device_s <= 0:
        return None
    least = records["linear_least_s_per_step"] * records["traced_steps"]
    return 100.0 * least / device_s
