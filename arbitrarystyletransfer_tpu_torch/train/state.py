"""The optimizer: the twin of ``train/state.py``'s optax chain.

``Adam`` reproduces ``optax.chain(clip_by_global_norm(c), adam(lr, b1, b2,
eps))`` update for update: the clip keeps the gradients below the norm and
scales them by ``(g / norm) * c`` above it (no ``+1e-6`` as in
``clip_grad_norm_``), and Adam adds ``eps`` outside the square root of the
bias-corrected second moment.  The moments are kept as one flat tensor each,
so a step is a handful of kernels whatever the number of parameters.

``apply_if_finite`` is ``apply_gradients_if_finite``: a non-finite global
gradient norm leaves the parameters, the moments and the count unchanged,
decided on the device (no host sync); the trainers gate the step counter and
the BatchNorm running buffers on the same flag (``keep_if``).

``deterministic_algorithms`` holds cuDNN to its deterministic algorithms
for the duration of a train step, so that a step from the same state gives
the same bits on every run.
"""

from __future__ import annotations

import contextlib

import torch


class Adam:
    """Global-norm clip then Adam over ``named_params`` [(name, tensor)],
    updating the tensors in place."""

    def __init__(self, named_params, lr: float, b1: float, b2: float,
                 eps: float, grad_clip_norm: float | None = None):
        self.names = [name for name, _ in named_params]
        self.params = [p for _, p in named_params]
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.clip = grad_clip_norm
        self.sizes = [p.numel() for p in self.params]
        device = self.params[0].device
        total = sum(self.sizes)
        self.mu = torch.zeros(total, device=device)
        self.nu = torch.zeros(total, device=device)
        self.count = torch.zeros((), dtype=torch.int32, device=device)

    def apply_if_finite(self, grads):
        """One update from ``grads`` (one per parameter, None for none)
        unless their global norm is not finite.  Returns (norm, ok), both
        device tensors."""
        g = torch.cat([
            (torch.zeros_like(p) if gr is None else gr).reshape(-1).float()
            for p, gr in zip(self.params, grads)])
        norm = torch.linalg.vector_norm(g)
        ok = torch.isfinite(norm)
        if self.clip is not None:
            g = torch.where(norm < self.clip, g, g / norm * self.clip)
        count = self.count + 1
        mu = (1 - self.b1) * g + self.b1 * self.mu
        nu = (1 - self.b2) * g * g + self.b2 * self.nu
        mu_hat = mu / (1 - torch.pow(self.b1, count))
        nu_hat = nu / (1 - torch.pow(self.b2, count))
        update = torch.where(ok, mu_hat / (torch.sqrt(nu_hat) + self.eps), 0.0)
        with torch.no_grad():
            torch._foreach_add_(
                self.params,
                [u.view_as(p) for u, p in zip(update.split(self.sizes),
                                              self.params)],
                alpha=-self.lr)
        self.mu = torch.where(ok, mu, self.mu)
        self.nu = torch.where(ok, nu, self.nu)
        self.count = torch.where(ok, count, self.count)
        return norm, ok

    def state_dict(self):
        """{"mu": {name: tensor}, "nu": {...}, "count": tensor}."""
        def split(flat):
            return {n: t.view_as(p) for n, t, p in
                    zip(self.names, flat.split(self.sizes), self.params)}

        return {"mu": split(self.mu), "nu": split(self.nu),
                "count": self.count}

    def load_state_dict(self, state) -> None:
        for key in ("mu", "nu"):
            if set(state[key]) != set(self.names):
                raise KeyError(f"optimizer state {key!r} does not match the "
                               "parameters")
            flat = torch.cat([state[key][n].reshape(-1) for n in self.names])
            setattr(self, key, flat.to(self.mu.device, torch.float32))
        self.count = torch.as_tensor(state["count"], dtype=torch.int32,
                                     device=self.mu.device)


@contextlib.contextmanager
def deterministic_algorithms():
    """cuDNN's deterministic algorithms, chosen without benchmarking, for
    the duration of the block (or of the decorated call), the caller's
    settings restored after it.  Some of cuDNN's weight-gradient algorithms
    add their partial sums in an order that changes from run to run."""
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = saved


@torch.no_grad()
def keep_if(ok, tensors, before) -> None:
    """Where ``ok`` (a device bool) is false, put ``tensors`` back to
    ``before`` (their values flattened into one tensor), without a host
    sync."""
    kept = torch.where(ok, torch.cat([t.reshape(-1) for t in tensors]),
                       before)
    torch._foreach_copy_(tensors, [
        t.view_as(b) for t, b in
        zip(kept.split([b.numel() for b in tensors]), tensors)])
