"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit), as ``mmlspark_tpu_torch/
observability/roofline.py`` states them. The benchmark keeps its own copy so
that a change to the program cannot move its yardstick."""

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
