"""The reference of no codec: the peers receive the trained rows as they
are, and there are no residuals."""


def exchange(trained, ef, comp, out_ef):
    return trained, 0.0
