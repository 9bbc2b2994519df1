"""idle_share.prove: one minus the device's busy time (the union of its
operations' intervals) over the traced window, from the profiler's trace.
Its spans label the idle gaps of the run's breakdown by the layer the host
was in."""

SPANS = [
    ("kogarashi_tpu_torch.r1cs.vector:SquareChainCircuit.build", "witness synthesis (host)", False),
    ("kogarashi_tpu_torch.groth16.prover:matvec", "ops/spmv.py matvec", False),
    ("kogarashi_tpu_torch.ops.ntt:Domain.idft", "ops/ntt.py idft", False),
    ("kogarashi_tpu_torch.ops.ntt:Domain.coset_dft", "ops/ntt.py coset_dft", False),
    ("kogarashi_tpu_torch.ops.ntt:Domain.coset_idft", "ops/ntt.py coset_idft", False),
    ("kogarashi_tpu_torch.groth16.prover:msm", "ops/msm.py msm", False),
    ("kogarashi_tpu_torch.groth16.prover:decode_points", "decode to host", False),
]


def read(run):
    return run.idle_share()
