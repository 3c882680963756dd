"""Data-sheet peaks of one NVIDIA H100 SXM 80GB (HBM3) at its 700 W power
limit, frozen here for the benchmark (the same values as the program's
``launch/roofline.py``). A card set below 700 W runs slower under load;
the runs print its power limit beside the shares of these peaks.
"""

CARD = "NVIDIA H100 SXM 80GB HBM3, 700 W (data sheet)"
FP32_FLOPS = 67e12        # fp32 outside the tensor cores (TF32 off)
HBM_BYTES_PER_S = 3.35e12
