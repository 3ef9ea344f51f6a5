"""Trainer of the port (memcnet_tpu/train/trainer.py): the upstream Adamax
configuration with optax's numbers, train steps and a training loop.

The reference ships no trainer, but documents the upstream one's
hyperparameters (my_args.py:41-59): Adamax at lr 2e-3, per-subnet relative
learning rates (flow 0.01x, occlusion and filter 1.0x), Charbonnier epsilon
1e-6, loss alpha [1.0, 0.0] over the [interpolated, rectified] residuals,
weight decay 0 and ReduceLROnPlateau(patience=5, factor=0.2).
``build_interp_trainer`` reproduces that from a Config.

``Adamax`` is the JAX package's optax chain -- clip_by_global_norm,
add_decayed_weights, adamax, the subnet scales, reduce_on_plateau -- step
for step, which ``torch.optim`` is not:
  * the plateau counts this step's loss before it scales this step's update,
    and reduces when the count of steps without improvement *equals*
    ``patience`` (torch's scheduler acts one step later on both counts);
  * clipping scales by max_norm / norm when norm >= max_norm (torch's
    ``clip_grad_norm_`` adds 1e-6 to the norm);
  * a trainable parameter without a gradient (MEMC_Net_star's ctx conv,
    whose only use is detached) takes a zero gradient, so weight decay still
    reaches it, and one step count serves every parameter's bias correction.
Parameters are updated in place (``_foreach_add_``), which bumps their
version counters: K4's packed-weight cache (ops/cuda/conv_kernel.py) keys
on them.

A train step is the train-mode forward, ``residual_loss``, autograd's
backward and the optimizer step.  On the card the forward runs the hand
kernels (K1, K2, K4, K5) and the backward autograd of their plain versions,
as the JAX custom_vjps differentiate their XLA formulations.  BatchNorm's
running statistics are updated by the forward in the modules' buffers.
Steps run on ``cuda`` unless the caller asks for the CPU.
"""

import os

import numpy as np
import torch
from torch.profiler import record_function

from memcnet_tpu_torch.cli.runner import resolve_device
from memcnet_tpu_torch.io import checkpoint
from memcnet_tpu_torch.train.loss import residual_loss

# my_args.py:44-46 relative learning rates, keyed on parameter-name prefix
SUBNET_LR = {"flownets": 0.01, "spynet": 0.01,
             "initScaleNets_occlusion": 1.0, "initScaleNets_filter": 1.0}


def subnet_coef(name, coefs):
    """The coefficient of the first prefix of ``coefs`` that ``name`` starts
    with, else 1.0."""
    for prefix, c in coefs.items():
        if name.startswith(prefix):
            return c
    return 1.0


class Adamax:
    """optax's chain of ``make_optimizer`` over named parameters, applied in
    place by ``step(loss)`` from the parameters' ``.grad``.

    Args:
      params: an ``nn.Module`` (its named parameters) or a {name: tensor}
        dict of leaf tensors.
      lr, weight_decay, clip_norm, subnet_lr, plateau, patience, factor: as
        ``make_optimizer``.
      b1, b2, eps: optax.adamax's defaults.
    """

    RTOL = 1e-4  # optax reduce_on_plateau's improvement test; atol 0, cooldown 0

    def __init__(self, params, lr=2e-3, weight_decay=0.0, *, clip_norm=None, subnet_lr=None,
                 plateau=False, patience=5, factor=0.2, b1=0.9, b2=0.999, eps=1e-8):
        named = list(params.named_parameters() if isinstance(params, torch.nn.Module)
                     else params.items())
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.lr, self.weight_decay, self.clip_norm = lr, weight_decay, clip_norm
        self.b1, self.b2, self.eps = b1, b2, eps
        coefs = None if subnet_lr is None else SUBNET_LR if subnet_lr is True else subnet_lr
        self.coefs = None if coefs is None else [subnet_coef(n, coefs) for n in self.names]
        self.plateau, self.patience, self.factor = plateau, patience, factor
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        # the plateau's scale is held in the parameters' lowest type, as optax does
        self.scale_dtype = min((p.dtype for p in self.params),
                               key=lambda d: torch.finfo(d).bits)
        self.scale = torch.ones((), dtype=self.scale_dtype)
        self.best = np.float32(np.inf)
        self.plateau_count = 0

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    def _plateau_update(self, loss):
        """reduce_on_plateau's state update for this step's loss (float32)."""
        value = np.float32(loss)
        if value < np.float32(1.0 - self.RTOL) * self.best:
            self.best, self.plateau_count = value, 0
        else:
            self.plateau_count += 1
        if self.plateau_count == self.patience:
            self.scale = self.scale * torch.tensor(self.factor, dtype=self.scale_dtype)
            self.plateau_count = 0

    @torch.no_grad()
    def step(self, loss=None):
        """One update from the parameters' gradients (a missing one counts
        as zero); ``loss`` (this step's, a float or a 0-d tensor) feeds the
        plateau and is required with it."""
        self._update(self.params, self._gradients(), loss)

    def _gradients(self):
        """This step's gradients, a missing one as zeros, clipped by their
        global norm."""
        u = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        if self.clip_norm:
            norm = float(torch.linalg.vector_norm(torch.stack(
                [n.float() for n in torch._foreach_norm(u)])))
            if not norm < self.clip_norm:
                u = torch._foreach_mul(torch._foreach_div(u, norm), self.clip_norm)
        return u

    def _update(self, params, u, loss):
        """Weight decay, adamax, the subnet scales and the plateau, applied
        in place to ``params`` with the gradients ``u`` (``self.mu`` and
        ``self.nu`` hold the same shapes)."""
        if self.weight_decay:
            u = torch._foreach_add(u, params, alpha=self.weight_decay)
        # scale_by_adamax: mu = b1 mu + (1 - b1) g; nu = max(|g| + eps, b2 nu);
        # update = mu / (1 - b1^count) / nu, bias correction in float32
        self.count += 1
        torch._foreach_mul_(self.mu, self.b1)
        torch._foreach_add_(self.mu, u, alpha=1.0 - self.b1)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_maximum_(self.nu, torch._foreach_add(torch._foreach_abs(u), self.eps))
        bc = float(np.float32(1.0) - np.power(np.float32(self.b1), np.float32(self.count),
                                              dtype=np.float32))
        bc_in = {dt: float(torch.tensor(bc).to(dt)) for dt in {m.dtype for m in self.mu}}
        upd = torch._foreach_div(self.mu, [bc_in[m.dtype] for m in self.mu])
        torch._foreach_div_(upd, self.nu)
        torch._foreach_mul_(upd, -self.lr)
        if self.coefs is not None:
            torch._foreach_mul_(upd, self.coefs)
        if self.plateau:
            if loss is None:
                raise ValueError("Adamax with the plateau needs this step's loss")
            self._plateau_update(float(loss))
            torch._foreach_mul_(upd, float(self.scale))
        torch._foreach_add_(params, upd)

    def _whole(self, state, i):
        """Parameter i's whole optimizer state tensor (this optimizer holds it
        all)."""
        return state

    def _local(self, state, i):
        """The part of parameter i's whole state tensor this optimizer holds."""
        return state

    def state_dict(self):
        """The optimizer state by parameter name (checkpoints)."""
        return {"count": self.count,
                "mu": {n: self._whole(m, i).detach().cpu()
                       for i, (n, m) in enumerate(zip(self.names, self.mu))},
                "nu": {n: self._whole(v, i).detach().cpu()
                       for i, (n, v) in enumerate(zip(self.names, self.nu))},
                "plateau": {"best": float(self.best), "plateau_count": self.plateau_count,
                            "scale": float(self.scale)}}

    def load_state_dict(self, sd):
        """The inverse of ``state_dict``: restores the step count, mu and nu
        by parameter name (each on its parameter's device, in the type of
        this optimizer's own state tensor) and the plateau.  Raises on a
        missing or extra name or a shape that differs."""
        for key in ("mu", "nu"):
            names, want = set(sd[key]), set(self.names)
            if names != want:
                raise KeyError(f"Adamax.load_state_dict: {key} lacks {sorted(want - names)}, "
                               f"has extra {sorted(names - want)}")
            for n, p in zip(self.names, self.params):
                if tuple(sd[key][n].shape) != tuple(p.shape):
                    raise ValueError(f"Adamax.load_state_dict: {key}[{n!r}] has shape "
                                     f"{tuple(sd[key][n].shape)}, the parameter {tuple(p.shape)}")
        for key in ("mu", "nu"):
            setattr(self, key, [self._local(sd[key][n], i).to(device=cur.device,
                                                               dtype=cur.dtype).clone()
                                for i, (n, cur) in enumerate(zip(self.names,
                                                                 getattr(self, key)))])
        self.count = int(sd["count"])
        plateau = sd["plateau"]
        self.best = np.float32(plateau["best"])
        self.plateau_count = int(plateau["plateau_count"])
        self.scale = torch.tensor(plateau["scale"], dtype=self.scale_dtype)


def make_optimizer(params, lr=2e-3, weight_decay=0.0, *, clip_norm=None, subnet_lr=None,
                   plateau=False, patience=5, factor=0.2):
    """Adamax per the upstream hyperparameters over ``params`` (a module or a
    {name: tensor} dict): optionally clipped by global norm, with weight
    decay, per-subnet LRs (``True`` for SUBNET_LR, or a {prefix: coef} dict)
    and the plateau (which reads each step's loss)."""
    return Adamax(params, lr, weight_decay, clip_norm=clip_norm, subnet_lr=subnet_lr,
                  plateau=plateau, patience=patience, factor=factor)


class TrainStep:
    """One optimizer step per call: train-mode forward, ``loss_fn``,
    backward, ``optimizer.step(loss)``.  Inputs (tensors or numpy arrays)
    move to the step's device in the parameters' type.  After a call each
    parameter's ``.grad`` holds that step's gradient.  Returns the loss
    (float32, detached)."""

    def __init__(self, model, optimizer, loss_fn, device="cuda"):
        self.device = resolve_device(device)
        self.dtype = next(model.parameters()).dtype
        for p in model.parameters():
            if p.device.type != self.device.type:
                raise ValueError(f"the model is on {p.device}, the step on {self.device}: "
                                 "move the model with model.to(device)")
        self.model, self.optimizer, self.loss_fn = model, optimizer, loss_fn

    def _input(self, x):
        if isinstance(x, (list, tuple)):
            return [self._input(t) for t in x]
        return torch.as_tensor(x).to(device=self.device, dtype=self.dtype)

    def __call__(self, *inputs):
        inputs = [self._input(x) for x in inputs]
        self.model.train()
        self.optimizer.zero_grad()
        with record_function("train_step.forward"):
            loss = self.loss_fn(*inputs)
        with record_function("train_step.backward"):
            loss.backward()
        with record_function("train_step.optimizer"):
            self.optimizer.step(loss.detach())
        return loss.detach()


def interp_loss_fn(model, alpha=(1.0, 1.0), eps=1e-6):
    """``loss(x0, x1, x2)`` of the interpolation models (triplet supervision,
    x1 the middle frame); alpha weights the [interpolated, rectified]
    Charbonnier residuals."""

    def loss_fn(x0, x1, x2):
        residuals, _offs, _filt, _occ = model.train_residuals(x0, x1, x2)
        return residual_loss(residuals, list(alpha), eps)

    return loss_fn


def make_interp_train_step(model, optimizer, alpha=(1.0, 1.0), eps=1e-6, *, device="cuda"):
    """Train step ``step(x0, x1, x2)`` of the interpolation models
    (``interp_loss_fn``)."""
    return TrainStep(model, optimizer, interp_loss_fn(model, alpha, eps), device)


def make_ve_train_step(model, optimizer, eps=1e-6, *, device="cuda"):
    """Train step ``step(frames, y)`` of MEMC_Net_VE (7-frame window, center
    target)."""

    def loss_fn(frames, y):
        return residual_loss(model.train_residuals(frames, y), eps=eps)

    return TrainStep(model, optimizer, loss_fn, device)


def build_interp_trainer(model, cfg=None, *, device="cuda", **overrides):
    """The documented upstream configuration, end to end: Adamax(cfg.lr),
    subnet relative LRs, plateau decay, no clipping, alpha=cfg.alpha,
    eps=cfg.epsilon; ``overrides`` go to ``make_optimizer``.  Returns
    (optimizer, step)."""
    from memcnet_tpu_torch.utils.config import Config

    cfg = cfg or Config()
    kw = dict(lr=cfg.lr, subnet_lr=True, plateau=True, clip_norm=None)
    kw.update(overrides)
    opt = make_optimizer(model, **kw)
    step = make_interp_train_step(model, opt, alpha=tuple(cfg.alpha), eps=cfg.epsilon,
                                  device=device)
    return opt, step


def fit(step, batches, *, steps, eval_every=0, eval_fn=None, checkpoint_dir=None, log=print):
    """Training loop: ``step`` over a batch iterator of (x0, gt, x1), at
    most ``steps`` times; every ``eval_every`` steps a log line (with
    ``eval_fn(model)`` where given) and a checkpoint of the model and the
    optimizer state (io.checkpoint, ``checkpoint_dir/step_<n>.pt``).
    Raises if a loss is not finite.  Returns the losses.  The JAX ``fit``
    takes and returns the params and the optimizer state explicitly; here
    they live in ``step.model`` and ``step.optimizer``, so a run resumes from
    ``step_<n>.pt`` by loading them there first (``io.checkpoint.load``:
    ``load_params(step.model, ckpt["params"])`` and
    ``step.optimizer.load_state_dict(ckpt["opt_state"])``) and passing the
    batches after the n-th."""
    history = []
    for i, (x0, gt, x1) in zip(range(steps), batches):
        loss = float(step(x0, gt, x1))
        if not np.isfinite(loss):
            raise FloatingPointError(f"loss diverged at step {i}: {loss}")
        history.append(loss)
        if eval_every and (i + 1) % eval_every == 0:
            msg = f"step {i + 1}: loss {loss:.5f}"
            if eval_fn is not None:
                msg += f", eval {eval_fn(step.model):.4f}"
            log(msg)
            if checkpoint_dir:
                os.makedirs(checkpoint_dir, exist_ok=True)
                checkpoint.save(os.path.join(checkpoint_dir, f"step_{i + 1}.pt"), step.model,
                                opt_state=step.optimizer.state_dict(), step=i + 1)
    return history
