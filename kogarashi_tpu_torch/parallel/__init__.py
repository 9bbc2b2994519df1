"""The distributed leg on torch.distributed: NCCL on the cards, gloo on the CPU.

Counterpart of `kogarashi_tpu/parallel/` (`make_mesh`, `distributed_msm_pallas`
as `distributed_msm`, `DistributedDomain`, `distributed_h_coeffs`) and of
`__graft_entry__.py::dryrun_multichip`. Ranks are processes started by
`launch.launch`, each on its own device; the functions take and return the rank's
view, as the bodies of the JAX package's `shard_map` do.
"""

from .dryrun import dryrun_multichip
from .msm import distributed_msm, make_mesh
from .ntt import DistributedDomain
from .prover import distributed_h_coeffs

__all__ = [
    "distributed_msm",
    "make_mesh",
    "DistributedDomain",
    "distributed_h_coeffs",
    "dryrun_multichip",
]
