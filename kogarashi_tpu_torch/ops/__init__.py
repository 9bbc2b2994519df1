"""Device ops: Weierstrass point kernels (`ec`), Edwards kernels
(`edwards`), Pippenger MSM (`msm`), NTT (`ntt`), sparse products (`spmv`),
fixed-base multiplication (`fixed_base`)."""
