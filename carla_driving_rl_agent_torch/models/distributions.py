"""The policy distributions: Beta (reference core/networks.py:128-144),
and the diagonal Gaussian and factored Categorical of the generic networks
(reference rl/networks/networks.py:74-100).

Counterpart of carla_driving_rl_agent_tpu/models/distributions.py.
torch.distributions.Beta cannot take a generator, so `sample` draws the two
Gamma variates itself (Marsaglia-Tsang) from an explicit torch.Generator.
`rsample` is the reparameterised draw of the policy objective's
`resample_actions` (JAX carla_agent.py:290-296): jax.random.beta
differentiates its Gamma variates implicitly, and so does `_ImplicitGamma`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

EPSILON = 1e-7  # clip bound of the actions (reference rl/utils.py)


def _log_beta_fn(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)


def sample_gamma(conc: torch.Tensor, gen: torch.Generator,
                 candidates: int = 4) -> torch.Tensor:
    """Gamma(conc, 1) variates by Marsaglia and Tsang's squeeze-free
    rejection method (ACM TOMS 26(3), 2000).  Each round proposes
    `candidates` values per element and keeps the first accepted one; the
    loop repeats only for elements whose proposals were all rejected (for
    conc >= 1 a proposal is rejected with probability < 5 %).  For conc < 1
    it uses Gamma(conc) = Gamma(conc + 1) * U^(1/conc)."""
    boost = conc < 1.0
    a = torch.where(boost, conc + 1.0, conc)
    d = a - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    out = torch.empty_like(a)
    pending = torch.ones_like(a, dtype=torch.bool)
    while True:
        shape = (candidates,) + tuple(a.shape)
        x = torch.randn(shape, generator=gen, device=a.device, dtype=a.dtype)
        u = torch.rand(shape, generator=gen, device=a.device, dtype=a.dtype)
        v = (1.0 + c * x) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v
                        + d * torch.log(torch.clamp(v, min=1e-30)))
        first = torch.argmax(ok.to(torch.int8), dim=0, keepdim=True)
        value = (d * torch.gather(v, 0, first))[0]
        accepted = torch.gather(ok, 0, first)[0]
        take = pending & accepted
        out = torch.where(take, value, out)
        pending = pending & ~accepted
        if not bool(pending.any()):
            break
    u = torch.rand(a.shape, generator=gen, device=a.device, dtype=a.dtype)
    return torch.where(boost, out * u ** (1.0 / conc), out)


class _ImplicitGamma(torch.autograd.Function):
    """x, a Gamma(conc, 1) variate drawn without a graph, as a function of
    conc: the implicit reparameterisation gradient dx/dconc = -(dF/dconc) /
    p(x) of its CDF F, which torch._standard_gamma_grad computes (the
    gradient that jax.random.gamma's custom JVP gives)."""

    @staticmethod
    def forward(ctx, conc, x):
        ctx.save_for_backward(conc, x)
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        conc, x = ctx.saved_tensors
        return g * torch._standard_gamma_grad(conc, x), None


@dataclass
class Beta:
    """Beta(alpha, beta) over [0, 1], elementwise over the action axis."""

    alpha: torch.Tensor
    beta: torch.Tensor

    def sample(self, gen: torch.Generator) -> torch.Tensor:
        x = sample_gamma(self.alpha, gen)
        y = sample_gamma(self.beta, gen)
        return x / (x + y)

    def rsample(self, gen: torch.Generator, gammas=None) -> torch.Tensor:
        """A sample through which gradients reach alpha and beta: the Gamma
        variates x ~ Gamma(alpha), y ~ Gamma(beta) drawn from `gen` as
        `sample` draws them, or the given `gammas` (x, y) (a test feeds
        JAX's), each differentiated implicitly, then x / (x + y)."""
        if gammas is None:
            with torch.no_grad():
                gammas = (sample_gamma(self.alpha, gen), sample_gamma(self.beta, gen))
        x = _ImplicitGamma.apply(self.alpha, gammas[0])
        y = _ImplicitGamma.apply(self.beta, gammas[1])
        return x / (x + y)

    def sample_n(self, gen: torch.Generator, n: int) -> torch.Tensor:
        """n iid samples, shape (n,) + batch shape (the block rollout draws
        past_obs_freq actions from one forward pass)."""
        shape = (n,) + tuple(self.alpha.shape)
        x = sample_gamma(self.alpha.expand(shape), gen)
        y = sample_gamma(self.beta.expand(shape), gen)
        return x / (x + y)

    def clip(self, x: torch.Tensor) -> torch.Tensor:
        """Clip actions away from {0, 1} (reference core/networks.py:139-144)."""
        return torch.clamp(x, EPSILON, 1.0 - EPSILON)

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        x = self.clip(x)
        return ((self.alpha - 1.0) * torch.log(x)
                + (self.beta - 1.0) * torch.log1p(-x)
                - _log_beta_fn(self.alpha, self.beta))

    def entropy(self) -> torch.Tensor:
        a, b = self.alpha, self.beta
        return (_log_beta_fn(a, b)
                - (a - 1.0) * torch.digamma(a)
                - (b - 1.0) * torch.digamma(b)
                + (a + b - 2.0) * torch.digamma(a + b))

    def mean(self) -> torch.Tensor:
        return self.alpha / (self.alpha + self.beta)

    def stddev(self) -> torch.Tensor:
        a, b = self.alpha, self.beta
        s = a + b
        return torch.sqrt(a * b / (s * s * (s + 1.0)))


@dataclass
class Gaussian:
    """Diagonal Gaussian for unbounded Box spaces (reference
    rl/networks/networks.py:93-100).  Its log_prob is per action
    dimension, as the JAX package's."""

    mu: torch.Tensor
    log_std: torch.Tensor

    def sample(self, gen: torch.Generator) -> torch.Tensor:
        noise = torch.randn(self.mu.shape, generator=gen, device=self.mu.device,
                            dtype=self.mu.dtype)
        return self.mu + torch.exp(self.log_std) * noise

    def clip(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        var = torch.exp(2.0 * self.log_std)
        return -0.5 * (torch.square(x - self.mu) / var
                       + 2.0 * self.log_std + math.log(2.0 * math.pi))

    def entropy(self) -> torch.Tensor:
        return 0.5 * (1.0 + math.log(2.0 * math.pi)) + self.log_std

    def mean(self) -> torch.Tensor:
        return self.mu

    def stddev(self) -> torch.Tensor:
        return torch.exp(self.log_std)


@dataclass
class Categorical:
    """Categorical over the last axis of `logits` (..., num_actions,
    num_classes), factored over the action components (reference
    rl/networks/networks.py:74-88).  Samples are class indices as floats."""

    logits: torch.Tensor

    def sample(self, gen: torch.Generator) -> torch.Tensor:
        p = torch.softmax(self.logits, dim=-1)
        flat = p.reshape(-1, p.shape[-1])
        idx = torch.multinomial(flat, 1, generator=gen)[:, 0]
        return idx.reshape(p.shape[:-1]).to(torch.float32)

    def clip(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        logp = torch.log_softmax(self.logits, dim=-1)
        return torch.gather(logp, -1, x.to(torch.int64)[..., None])[..., 0]

    def entropy(self) -> torch.Tensor:
        logp = torch.log_softmax(self.logits, dim=-1)
        return -torch.sum(torch.exp(logp) * logp, dim=-1)

    def _classes(self) -> torch.Tensor:
        return torch.arange(self.logits.shape[-1], dtype=self.logits.dtype,
                            device=self.logits.device)

    def mean(self) -> torch.Tensor:
        p = torch.softmax(self.logits, dim=-1)
        return torch.sum(p * self._classes(), dim=-1)

    def stddev(self) -> torch.Tensor:
        p = torch.softmax(self.logits, dim=-1)
        c = self._classes()
        m = torch.sum(p * c, dim=-1, keepdim=True)
        return torch.sqrt(torch.sum(p * torch.square(c - m), dim=-1))
