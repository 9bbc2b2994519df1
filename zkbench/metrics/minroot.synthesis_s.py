"""minroot.synthesis_s: seconds a MinRoot folding step spends in host
synthesis of the augmented circuits (`AugmentedFCircuit.generate`, between
device synchronisations), per traced step."""

SPANS = [("kogarashi_tpu_torch.nova.augmented:AugmentedFCircuit.generate", "minroot synthesis", True)]


def read(run):
    v = run.parts.get("minroot synthesis")
    return v / run.traced_requests if v is not None and run.traced_requests else None
