"""Member-steps a second: one member's training step on one minibatch
counts one; every step completed in the window over the window's wall,
from its opening to the synchronised close at the boundary that ends it."""


def read(run):
    w = run.window
    return w["member_steps"] / (w["t1"] - w["t0"])
