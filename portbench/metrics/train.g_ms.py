"""Mean device ms of G's phase a step: CUDA events at Trainer.step's start and at its
on_phase("g") hook, over the window's steps."""


def read(ctx):
    g = ctx.get("phase_ms", {}).get("g")
    return sum(g) / len(g) if g else None
