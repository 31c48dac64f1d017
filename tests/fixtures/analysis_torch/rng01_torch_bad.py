"""RNG01 fixture: torch's module-global generator, seeded and drawn from."""
import torch
from torch import randn


def seed_everything(seed):
    torch.manual_seed(seed)
    torch.cuda.manual_seed_all(seed)
    return torch.seed()


def draws(p, rates):
    return (torch.rand(3), randn(2, generator=None), torch.randint(0, 5, (3,)),
            torch.randperm(4), torch.normal(0.0, 1.0, (2,)), torch.bernoulli(p),
            torch.multinomial(p, 2), torch.poisson(rates))


def in_place(t, w):
    t.uniform_()
    t.normal_(0.0, 1.0)
    t.random_(0, 10)
    t.exponential_()
    t.bernoulli_(0.5)
    t.geometric_(0.3)
    t.cauchy_()
    t.log_normal_()
    torch.nn.init.normal_(w)
    return t
