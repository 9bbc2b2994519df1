"""minroot.step_synthesis_s: seconds a folding step spends synthesizing the
primary's step function (the MinRoot rounds), from the port's stage mark
"nova primary step synthesis", per traced step."""


def read(run):
    v = run.marks.get("nova primary step synthesis")
    return sum(v) / run.traced_requests if v and run.traced_requests else None
