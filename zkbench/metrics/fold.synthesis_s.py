"""fold.synthesis_s: seconds a folding step spends in host synthesis of the
augmented circuits (`AugmentedFCircuit.generate`, between device
synchronisations), per traced step."""

SPANS = [("kogarashi_tpu_torch.nova.augmented:AugmentedFCircuit.generate", "synthesis", True)]


def read(run):
    v = run.parts.get("synthesis")
    return v / run.traced_requests if v is not None and run.traced_requests else None
