"""prove.msm_s: seconds a proof spends in its five MSMs, the sum of the
prover's "MSM ..." stage marks (mean over the traced proofs)."""


def read(run):
    v = [sum(s) / len(s) for k, s in run.marks.items() if k.startswith("prove MSM ") and s]
    return sum(v) if v else None
