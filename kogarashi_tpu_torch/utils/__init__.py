"""Host utilities of Nova: the reference's XorShift stream and the proof
codec."""
