# ktpu: sim-path
"""Seeded prng violations for the port's lint: torch draws on the global
generator, a reseed of it, and in-place draws; the draws that name a
generator= stay quiet."""

import torch


def jitter(n, gen):
    a = torch.rand(n)  # BAD: the global generator
    b = torch.randint(0, 10, (n,))  # BAD
    c = torch.empty(n).normal_()  # BAD: in-place draw
    torch.manual_seed(0)  # BAD: reseeds the global generator
    d = torch.rand(n, generator=gen)  # fine: an explicit generator
    e = torch.empty(n).uniform_(generator=gen)  # fine
    return a, b, c, d, e
