"""prove.witness_s: seconds a proof spends in host witness synthesis, from the
prover's stage mark "witness (host)" (mean over the traced proofs)."""


def read(run):
    v = run.marks.get("prove witness (host)")
    return sum(v) / len(v) if v else None
