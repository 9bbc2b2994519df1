"""Device ops: point kernels (`ec`), Pippenger MSM (`msm`), NTT (`ntt`),
sparse products (`spmv`), fixed-base multiplication (`fixed_base`)."""
