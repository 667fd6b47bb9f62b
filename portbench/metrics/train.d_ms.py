"""Mean device ms of the rest of a step: from the on_phase("g") hook to the step's end (G's
Adam step, D's phase, R1 amortized, D's Adam steps, EMA, ADA), over the window's steps."""


def read(ctx):
    d = ctx.get("phase_ms", {}).get("d")
    return sum(d) / len(d) if d else None
