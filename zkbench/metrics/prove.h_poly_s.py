"""prove.h_poly_s: seconds a proof spends on the H polynomial (SpMV and NTTs),
from the prover's stage mark (mean over the traced proofs)."""


def read(run):
    v = run.marks.get("prove H polynomial (SpMV, NTT)")
    return sum(v) / len(v) if v else None
