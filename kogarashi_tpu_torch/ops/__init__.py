"""Device ops: Weierstrass point kernels (`ec`), Edwards kernels
(`edwards`), Pippenger MSM (`msm`), NTT (`ntt`), sparse products (`spmv`),
fixed-base multiplication (`fixed_base`), the device pairing (`pairing`, with
the schedules P1 and P2 run, `pairing_schedule`)."""
