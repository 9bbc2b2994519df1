"""Host utilities: the reference's XorShift stream, the SCALE codec of
Nova and Groth16 proofs, and the ff-ecosystem surface (`ff_compat`)."""
