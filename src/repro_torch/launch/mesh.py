"""The card's constants for the roofline: the port of the reference's
``launch/mesh.py`` constants, for the NVIDIA H100 80GB HBM3 (SXM, 700 W)
the checks run on. One card has no collective, so there is no link rate;
the mesh functions come with multi-GPU sharding."""

# NVIDIA H100 SXM datasheet figures (dense, no sparsity)
HBM_BYTES_PER_S = 3.35e12         # HBM3 device memory
FP32_OPS_PER_S = 67e12            # fp32 outside the tensor cores
TF32_OPS_PER_S = 495e12           # TF32 on the tensor cores
SMS = 132                         # streaming multiprocessors
