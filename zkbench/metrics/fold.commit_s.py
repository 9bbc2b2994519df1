"""fold.commit_s: seconds a folding step spends in Pedersen commits on both
curves (`PedersenCommitment.commit`, between device synchronisations), per
traced step."""

SPANS = [("kogarashi_tpu_torch.nova.pedersen:PedersenCommitment.commit", "commit", True)]


def read(run):
    v = run.parts.get("commit")
    return v / run.traced_requests if v is not None and run.traced_requests else None
