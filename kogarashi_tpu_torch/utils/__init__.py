"""Host utilities: the reference's XorShift stream and the SCALE codec of
Nova and Groth16 proofs."""
