"""L-BFGS: counterpart of ``paddle_tpu/optimizer/lbfgs.py``.

The closure-driven optimizer: ``step(closure)`` runs up to ``max_iter``
L-BFGS iterations, each a two-loop recursion over the last
``history_size`` (s, y) pairs and, with ``line_search_fn="strong_wolfe"``,
a bracketing and bisection search (c1 1e-4, c2 0.9).  The outer loop needs
host values (the line search and the convergence tests), so it runs on
the host, as in the JAX package; the vector math runs on one flattened
parameter vector on the parameters' device.  It has no elementwise rule,
so the fused step never takes it (``optimizer/fused.py``).
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch

from .optimizer import Optimizer

__all__ = ["LBFGS"]


class LBFGS(Optimizer):
    def __init__(self, learning_rate=1.0, max_iter=20, max_eval=None,
                 tolerance_grad=1e-7, tolerance_change=1e-9,
                 history_size=100, line_search_fn: Optional[str] = None,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate=learning_rate, parameters=parameters,
                         weight_decay=weight_decay, grad_clip=grad_clip,
                         name=name)
        if line_search_fn not in (None, "strong_wolfe"):
            raise ValueError("line_search_fn must be None or 'strong_wolfe'")
        self.max_iter = max_iter
        self.max_eval = max_eval if max_eval is not None \
            else max_iter * 5 // 4
        self.tolerance_grad = tolerance_grad
        self.tolerance_change = tolerance_change
        self.history_size = history_size
        self.line_search_fn = line_search_fn
        self._s: List[torch.Tensor] = []     # parameter deltas
        self._y: List[torch.Tensor] = []     # gradient deltas
        self._n_evals = 0

    # ------------------------------------------------------------ vectors
    def _flat_params(self) -> torch.Tensor:
        return torch.cat([p.detach().reshape(-1)
                          for p in self._parameter_list])

    def _flat_grad(self) -> torch.Tensor:
        return torch.cat([p.grad.reshape(-1) if p.grad is not None
                          else torch.zeros(p.numel(), dtype=p.dtype,
                                           device=p.device)
                          for p in self._parameter_list])

    @torch.no_grad()
    def _assign(self, flat: torch.Tensor) -> None:
        off = 0
        for p in self._parameter_list:
            n = p.numel()
            p.copy_(flat[off:off + n].reshape(p.shape).to(p.dtype))
            off += n

    def _eval(self, closure: Callable, flat: torch.Tensor):
        self._assign(flat)
        self._n_evals += 1
        with torch.enable_grad():
            loss = closure()
        return float(loss), self._flat_grad()

    # ------------------------------------------------------------ two-loop
    def _direction(self, grad: torch.Tensor) -> torch.Tensor:
        q = grad
        alphas = []
        for s, y in zip(reversed(self._s), reversed(self._y)):
            rho = 1.0 / torch.dot(y, s)
            a = rho * torch.dot(s, q)
            alphas.append((a, rho, s, y))
            q = q - a * y
        if self._y:
            s, y = self._s[-1], self._y[-1]
            q = q * (torch.dot(s, y) / torch.dot(y, y))
        for a, rho, s, y in reversed(alphas):
            b = rho * torch.dot(y, q)
            q = q + (a - b) * s
        return -q

    # ---------------------------------------------------------- line search
    def _strong_wolfe(self, closure, x, d, f0, g0, lr):
        """Bracket + bisection strong-Wolfe search (c1=1e-4, c2=0.9)."""
        c1, c2 = 1e-4, 0.9
        dg0 = float(torch.dot(g0, d))
        if dg0 >= 0:
            return lr, *self._eval(closure, x + lr * d)
        t, t_prev = lr, 0.0
        f_prev, lo, hi = f0, None, None
        for _ in range(25):
            f_t, g_t = self._eval(closure, x + t * d)
            dg_t = float(torch.dot(g_t, d))
            if f_t > f0 + c1 * t * dg0 or (lo is not None and f_t >= f_prev):
                hi = t
                t = 0.5 * ((lo or t_prev) + t)
                lo = lo if lo is not None else t_prev
                continue
            if abs(dg_t) <= -c2 * dg0:
                return t, f_t, g_t
            if dg_t >= 0:
                hi = t
                t = 0.5 * ((lo if lo is not None else t_prev) + t)
                continue
            lo, f_prev, t_prev = t, f_t, t
            t = 2.0 * t if hi is None else 0.5 * (t + hi)
        f_t, g_t = self._eval(closure, x + t * d)
        return t, f_t, g_t

    # ---------------------------------------------------------------- step
    @torch.no_grad()
    def step(self, closure: Optional[Callable] = None):
        """One optimize call = up to ``max_iter`` L-BFGS iterations.
        ``closure`` clears the gradients, computes the loss, calls
        ``backward`` and returns the loss."""
        if closure is None:
            raise RuntimeError("LBFGS.step needs a closure that re-evaluates"
                               " the model")
        self._n_evals = 0
        lr = self.get_lr()
        x = self._flat_params()
        f, g = self._eval(closure, x)
        if float(g.abs().max()) <= self.tolerance_grad:
            return f
        for _ in range(self.max_iter):
            d = self._direction(g)
            if self.line_search_fn == "strong_wolfe":
                t, f_new, g_new = self._strong_wolfe(closure, x, d, f, g, lr)
            else:
                t = lr
                f_new, g_new = self._eval(closure, x + t * d)
            x_new = x + t * d
            s = x_new - x
            y = g_new - g
            if float(torch.dot(s, y)) > 1e-10:
                self._s.append(s)
                self._y.append(y)
                if len(self._s) > self.history_size:
                    self._s.pop(0)
                    self._y.pop(0)
            converged = (
                float(g_new.abs().max()) <= self.tolerance_grad
                or float(s.abs().max()) <= self.tolerance_change
                or abs(f_new - f) < self.tolerance_change)
            x, f, g = x_new, f_new, g_new
            if converged or self._n_evals >= self.max_eval:
                break
        self._assign(x)
        self._global_step += 1
        return f
