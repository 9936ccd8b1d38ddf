"""Host meshes and the card's constants for the roofline: the port of the
reference's ``launch/mesh.py``. ``make_host_mesh`` builds the ``(data,
model)`` mesh over the ranks of a ``torch.distributed`` group
(``sharding.mesh``); the TPU pod's ``make_production_mesh`` waits for the
dry run (ROADMAP A19). The constants are the NVIDIA H100 80GB HBM3's
(SXM, 700 W) the checks run on; no link rate is recorded yet."""
from repro_torch.sharding.mesh import HostMesh, make_host_mesh  # noqa: F401

# NVIDIA H100 SXM datasheet figures (dense, no sparsity)
HBM_BYTES_PER_S = 3.35e12         # HBM3 device memory
FP32_OPS_PER_S = 67e12            # fp32 outside the tensor cores
TF32_OPS_PER_S = 495e12           # TF32 on the tensor cores
SMS = 132                         # streaming multiprocessors

