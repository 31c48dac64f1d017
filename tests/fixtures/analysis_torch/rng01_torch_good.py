"""RNG01 fixture: every torch draw names its own seeded generator."""
import torch


def seeded(seed, p, rates, t):
    gen = torch.Generator().manual_seed(seed)
    a = (torch.rand(3, generator=gen), torch.randn(2, generator=gen),
         torch.randint(0, 5, (3,), generator=gen), torch.randperm(4, generator=gen),
         torch.normal(0.0, 1.0, (2,), generator=gen), torch.bernoulli(p, generator=gen),
         torch.multinomial(p, 2, generator=gen), torch.poisson(rates, generator=gen))
    t.uniform_(generator=gen)
    t.normal_(0.0, 1.0, generator=gen)
    torch.nn.init.normal_(t, generator=gen)
    return a, gen.initial_seed()
