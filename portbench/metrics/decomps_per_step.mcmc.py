"""Decompositions of Q a step (``reversible_eig`` calls, each a batch over
the chains): the program's ``physher.subst.eig`` spans in the traced
window."""

from portbench.spans import count_per_step


def read(r):
    return count_per_step(r, lambda name: name == "physher.subst.eig")
