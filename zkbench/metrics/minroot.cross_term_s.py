"""minroot.cross_term_s: seconds a MinRoot folding step spends in the NIFS
cross term (`R1csShape.cross_term`, between device synchronisations), per
traced step."""

SPANS = [("kogarashi_tpu_torch.nova.relaxed_r1cs:R1csShape.cross_term", "minroot cross term", True)]


def read(run):
    v = run.parts.get("minroot cross term")
    return v / run.traced_requests if v is not None and run.traced_requests else None
