"""ClientTrainer (port of fedml_tpu/core/trainer.py).

The JAX trainer is a set of pure functions over a variables pytree.  Here
a client's variables travel as ONE flat vector in the layout of
``trainer.spec``: the model's parameters in module order, then its
collections (BatchNorm's running ``mean`` and ``var``, the JAX trainer's
``rest``), padded with zeros to a multiple of 512 elements, as
``ops.aggregate`` pads its rows.  ``n_params`` is the boundary.  The
mesh engine's chunk fold then reads trained clients as the rows of a
[k, P] matrix without copying leaves together.  ``flatten``/``unflatten``
convert to and from ``{name: tensor}`` dicts.

A training step differentiates the parameter segment only; the optimizer
(and FedProx's term) sees only it.  The collections are copied out of the
vector, handed to the model as buffers, overwritten by its training
forward, and put back.  Without collections the whole padded vector is
the parameter segment (the pad's gradient is zero and stays zero under
every optimizer here), so a step is one elementwise update of the vector.

Parity with the JAX trainer, where it is not obvious:
* ``train_dtype=torch.bfloat16`` casts params and x to bf16 for the
  forward/backward and casts the logits to f32 before the loss
  (trainer.py:257-275).  The collections are not cast: BatchNorm's
  moving averages update in the vector's own dtype, f32 for f32 masters.
  With bf16 local masters (``parallel/engine.py::cast_local`` casts every
  float leaf, as the JAX engine's does) the vector and so the statistics
  are bf16: each step's update is computed in f32 and rounded back to
  bf16.  (The JAX engine cannot run that case: its batch scan rejects the
  f32 statistics a step returns for bf16 ones.)
* The optimizers are optax's, written out over flat tensors
  (``Optimizer``), with optax's roundings: each op rounded to the
  gradient's dtype, and Python scalars (lr, momentum, decay, the Adam
  constants) rounded to it first, as optax's weakly typed scalars are.
  Their state is flat tensors, created afresh by every ``local_train``
  as JAX's ``init_opt`` is.
* An all-padding batch scales the update by ``has_data`` = 0, keeps the
  optimizer state and the collections, and reports loss 0
  (trainer.py:336-349); a schedule's step count still advances
  (``tree_merge_counts``).  A partly padded batch is NOT masked inside
  BatchNorm: its zero rows enter the batch statistics, as in flax.
* Dropout draws from the `generator` passed to ``local_train`` (one per
  client per round, ``client_generator``), where JAX splits a key.
* ``augment(generator, x)`` (data/augment.py) runs in the training step
  only, on the float x before the cast to ``train_dtype``
  (trainer.py:253-255), and draws from the same generator before dropout
  does, as JAX splits the augmentation's key first.  Evaluation never
  augments.
* FedProx: with ``prox_mu`` > 0 and the round's global vector passed as
  ``global_params``, the loss gains (mu/2) * ||p - g||^2 over the
  parameters (trainer.py:298-308).
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from fedml_tpu_torch import obs
from fedml_tpu_torch.models import init_params
from fedml_tpu_torch.models.layers import in_dtype
from fedml_tpu_torch.ops.aggregate import spec_of, unflatten_to_tree
from fedml_tpu_torch.utils.device import resolve_device


# ---------------------------------------------------------------------------
# losses and metrics
# ---------------------------------------------------------------------------

def broadcast_mask(mask: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """A per-sample mask over trailing label axes (sequence time,
    segmentation H/W): [bs] -> target.shape."""
    return mask.reshape(mask.shape + (1,) * (target.dim() - mask.dim())
                        ).expand(target.shape)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor):
    """optax.softmax_cross_entropy_with_integer_labels, elementwise."""
    return torch.logsumexp(logits, dim=-1) \
        - logits.gather(-1, labels[..., None].long())[..., 0]


def sigmoid_binary_cross_entropy(logits: torch.Tensor, targets: torch.Tensor):
    """optax.sigmoid_binary_cross_entropy, elementwise."""
    return -targets * F.logsigmoid(logits) - (1.0 - targets) * F.logsigmoid(-logits)


def _masked_mean(v: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    mask = mask.to(v.dtype)
    return (v * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def masked_cross_entropy(logits, labels, mask):
    """Mean softmax CE over valid (mask=1) samples; labels are class ids."""
    return _masked_mean(softmax_cross_entropy(logits, labels), mask)


def masked_bce(logits, targets, mask):
    """Multi-label sigmoid BCE, the mean over the label axis, then over the
    valid samples (stackoverflow_lr's tag prediction)."""
    return _masked_mean(sigmoid_binary_cross_entropy(logits, targets)
                        .mean(dim=-1), mask)


def focal_from_ce(ce: torch.Tensor, gamma: float = 2.0, alpha: float = 0.5):
    """alpha * (1 - pt)^gamma * CE with pt = exp(-CE), elementwise."""
    return alpha * (1.0 - torch.exp(-ce)) ** gamma * ce


def masked_focal_loss(logits, labels, mask, gamma: float = 2.0,
                      alpha: float = 0.5):
    """Per-element focal loss (fedseg's FocalLoss, gamma 2, alpha 0.5),
    averaged over the valid elements."""
    return _masked_mean(focal_from_ce(softmax_cross_entropy(logits, labels),
                                      gamma, alpha), mask)


def masked_accuracy_sums(logits, labels, mask):
    """(n_correct, n_valid) so accuracies aggregate exactly across clients
    and batches."""
    ok = (logits.argmax(dim=-1) == labels).float() * mask.float()
    return ok.sum(), mask.float().sum()


LOSSES = {"ce": masked_cross_entropy, "bce": masked_bce,
          "focal": masked_focal_loss}


# ---------------------------------------------------------------------------
# learning-rate schedules and optimizers
# ---------------------------------------------------------------------------

def make_lr_schedule(mode: str, base_lr: float, total_steps: int,
                     iters_per_epoch: int = 1, lr_step_epochs: int = 0,
                     warmup_steps: int = 0) -> Callable:
    """The reference's LR_Scheduler (fedseg/utils.py:114-157) over the local
    step count T, an int32 tensor (trainer.py:49-78): poly lr*(1-T/N)^0.9,
    cos 0.5*lr*(1+cos(pi*T/N)), step lr*0.1^(epoch//lr_step), with linear
    warmup for T < warmup_steps.  Returns an f32 tensor."""
    if mode not in ("poly", "cos", "step"):
        raise ValueError(f"unknown lr schedule {mode!r}")
    if mode == "step" and not lr_step_epochs:
        raise ValueError("step schedule needs lr_step_epochs")
    N = max(total_steps, 1)

    def schedule(count: torch.Tensor) -> torch.Tensor:
        T = torch.clamp(count, max=N).float()
        if mode == "poly":
            lr = base_lr * (1.0 - T / N) ** 0.9
        elif mode == "cos":
            lr = 0.5 * base_lr * (1.0 + torch.cos(math.pi * T / N))
        else:
            epoch = torch.div(count, iters_per_epoch, rounding_mode="floor")
            lr = base_lr * 0.1 ** torch.div(epoch, lr_step_epochs,
                                            rounding_mode="floor")
        if warmup_steps > 0:
            lr = torch.where(T < warmup_steps, lr * T / warmup_steps, lr)
        return lr.float()

    return schedule


class Optimizer:
    """optax's client optimizers on one flat parameter vector:

    * sgd:   chain([clip], [add_decayed_weights(wd)], [trace(momentum)], lr)
    * adam:  chain([clip], [add_decayed_weights(wd)], scale_by_adam(b1, b2),
             lr)
    * adamw: chain([clip], scale_by_adam(b1, b2), add_decayed_weights(wd),
             lr) (adamw owns its decay: it is not chained twice,
             trainer.py:86)

    with scale_by_adam's eps 1e-8 and eps_root 0 (b1 0.9, b2 0.999 unless
    given) and lr a float or a schedule of the step count.  ``clip_norm``
    puts optax's ``clip_by_global_norm`` first: the gradient stays as it
    is while its norm is below the bound, else becomes g / ||g|| * bound
    (FedNAS's w optimizer clips before its decay).  State: ``trace``,
    ``mu``/``nu`` and ``adam_count`` as needed, and ``count``, the
    schedule's step."""

    EPS = 1e-8

    def __init__(self, name: str, lr, momentum: float = 0.0,
                 weight_decay: float = 0.0, clip_norm: Optional[float] = None,
                 b1: float = 0.9, b2: float = 0.999):
        if name not in ("sgd", "adam", "adamw"):
            raise ValueError(f"unknown optimizer {name!r}")
        self.name, self.lr = name, lr
        self.momentum, self.weight_decay = momentum, weight_decay
        self.clip_norm, self.B1, self.B2 = clip_norm, b1, b2

    def init(self, params: torch.Tensor) -> dict:
        count = lambda: torch.zeros((), dtype=torch.int32, device=params.device)
        state = {}
        if self.name == "sgd" and self.momentum:
            state["trace"] = torch.zeros_like(params)
        if self.name != "sgd":
            state.update(mu=torch.zeros_like(params),
                         nu=torch.zeros_like(params), adam_count=count())
        if callable(self.lr):
            state["count"] = count()
        return state

    def update(self, grads: torch.Tensor, state: dict,
               params: torch.Tensor) -> tuple[torch.Tensor, dict]:
        """(updates, new state); the caller adds the updates."""
        c = lambda v: in_dtype(v, grads.dtype)
        g, new = grads, {}
        if self.clip_norm is not None:
            norm = torch.sqrt((g * g).sum())
            g = torch.where(norm < c(self.clip_norm), g,
                            g / norm * c(self.clip_norm))
        if self.weight_decay and self.name != "adamw":
            g = g + c(self.weight_decay) * params
        if "trace" in state:
            g = new["trace"] = g + c(self.momentum) * state["trace"]
        if self.name != "sgd":
            mu = c(1 - self.B1) * g + c(self.B1) * state["mu"]
            nu = c(1 - self.B2) * (g * g) + c(self.B2) * state["nu"]
            n = state["adam_count"] + 1
            # the bias correction's power in f32 (f64 for f64 moments), as
            # JAX's weakly typed float ** int32 count
            correct = lambda m, b: m / (1 - b ** n.to(torch.promote_types(
                m.dtype, torch.float32))).to(m.dtype)
            g = correct(mu, self.B1) / (torch.sqrt(correct(nu, self.B2))
                                        + c(self.EPS))
            new.update(mu=mu, nu=nu, adam_count=n)
            if self.name == "adamw" and self.weight_decay:
                g = g + c(self.weight_decay) * params
        if callable(self.lr):
            new["count"] = state["count"] + 1
            return (-self.lr(state["count"])).to(g.dtype) * g, new
        return c(-self.lr) * g, new

    @staticmethod
    def select(has_data: torch.Tensor, new: dict, old: dict) -> dict:
        """The empty-batch guard over the state: keep the old state, except
        the schedule's step count, which always advances."""
        return {k: v if k == "count" else torch.where(has_data, v, old[k])
                for k, v in new.items()}


def make_optimizer(name: str, lr, momentum: float = 0.0,
                   weight_decay: float = 0.0) -> Optimizer:
    """Client optimizer factory: "sgd" (with optional momentum), "adam",
    "adamw"; `lr` a float or a schedule (make_lr_schedule)."""
    return Optimizer(name, lr, momentum, weight_decay)


def client_generator(seed: int, round_idx: int, client: int,
                     device) -> torch.Generator:
    """The dropout and augmentation generator of one client in one round,
    on `device`, seeded from (seed, round, client) through numpy's
    SeedSequence."""
    s = np.random.SeedSequence([seed, round_idx, client]).generate_state(1)[0]
    return torch.Generator(device=device).manual_seed(int(s))


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

class ClientTrainer:
    """Train/eval operator for one model, over flat variable vectors.

    Args:
      model: an nn.Module of the zoo; its own parameters and buffers are
        only the layout template (every call substitutes the flat
        vector's views).
      loss: "ce" | "bce" | "focal".
      optimizer / lr / momentum / weight_decay: the client optimizer
        (make_optimizer); lr a float or a make_lr_schedule schedule.
      prox_mu: FedProx proximal coefficient; when > 0, local_train takes
        the round's global flat vector and adds (mu/2)||p - g||^2.
      has_time_axis: labels carry a trailing sequence axis (the LMs): the
        per-sample mask is broadcast over it.
      train_dtype: compute dtype of the training forward/backward.
      augment: training-time augmentation (generator, x) -> x
        (data/augment.py), applied in the training step only.
      eval_ignore_id: label id left out of the eval metrics only (<pad>).
      train_ignore_id: label id left out of the training loss and the eval
        metrics (segmentation's void label), remapped to 0 for the gather.
      batch_axes: per-client batch splitting over a mesh axis, slice 6 of
        the port (raises).
    """

    def __init__(self, model: nn.Module, loss: str = "ce",
                 optimizer: str = "sgd", lr=0.03, momentum: float = 0.0,
                 weight_decay: float = 0.0, prox_mu: float = 0.0,
                 has_time_axis: bool = False, train_dtype=torch.float32,
                 augment: Optional[Callable] = None,
                 eval_ignore_id: Optional[int] = None,
                 train_ignore_id: Optional[int] = None,
                 batch_axes: tuple = ()):
        if loss not in LOSSES:
            raise ValueError(f"unknown loss {loss!r}")
        if batch_axes:
            raise NotImplementedError(
                "ClientTrainer(batch_axes=...), per-client batch splitting "
                "over a mesh axis, is slice 6 of the port")
        self.model = model
        self.loss_name = loss
        self.tx = make_optimizer(optimizer, lr, momentum, weight_decay)
        self.prox_mu = prox_mu
        self.has_time_axis = has_time_axis
        self.train_dtype = train_dtype
        self.augment = augment
        self.eval_ignore_id = eval_ignore_id
        self.train_ignore_id = train_ignore_id
        params = dict(model.named_parameters())
        stats = dict(model.named_buffers())
        self.spec = spec_of({**params, **stats})
        self.param_spec = spec_of(params)
        self.stat_spec = spec_of(stats)
        self.n_params, self.n_stats = self.param_spec.n, self.stat_spec.n
        # the segment a step differentiates and the optimizer updates
        self.train_len = self.n_params if self.n_stats else self.spec.padded

    @property
    def param_names(self) -> tuple:
        return self.param_spec.names

    @property
    def stat_names(self) -> tuple:
        return self.stat_spec.names

    # -- variables <-> flat vector ------------------------------------------
    def init(self, generator: torch.Generator, device=None) -> dict:
        """Fresh variables (flax's default initializers) on `device`."""
        device = resolve_device(device)
        return {k: v.to(device)
                for k, v in init_params(self.model, generator).items()}

    def flatten(self, variables: dict, dtype=None) -> torch.Tensor:
        """{name: tensor} -> one [spec.padded] vector (in `dtype`, default
        the variables' own), zero-padded at the tail."""
        leaves = [variables[n].reshape(-1) for n in self.spec.names]
        dtype = dtype or leaves[0].dtype
        tail = self.spec.padded - self.spec.n
        return torch.cat([l.to(dtype) for l in leaves]
                         + [leaves[0].new_zeros(tail, dtype=dtype)])

    def unflatten(self, flat: torch.Tensor, dtype=None) -> dict:
        """Inverse of `flatten`: views of `flat` (cast to `dtype` if given)."""
        return unflatten_to_tree(flat, self.spec, dtype or flat.dtype)

    def init_opt(self, flat: torch.Tensor) -> dict:
        """Fresh optimizer state for the parameter segment of `flat`."""
        return self.tx.init(flat[:self.train_len])

    # -- masks and loss -----------------------------------------------------
    def _masks(self, y, mask, ignore_ids):
        """(labels, mask) after the time-axis broadcast and the ignored ids
        (remapped to 0 so the CE gather stays in range)."""
        if self.has_time_axis and mask.dim() < y.dim():
            mask = broadcast_mask(mask, y)
        for ignore in ignore_ids:
            if ignore is not None:
                valid = y != ignore
                mask = mask * valid.to(mask.dtype)
                y = torch.where(valid, y, torch.zeros_like(y))
        return y, mask

    def _loss(self, p: torch.Tensor, stats: Optional[torch.Tensor],
              batch: dict, global_params: Optional[torch.Tensor],
              generator: Optional[torch.Generator]) -> torch.Tensor:
        x, y, mask = batch["x"], batch["y"], batch["mask"]
        half = self.train_dtype != torch.float32
        variables = unflatten_to_tree(p, self.param_spec,
                                      self.train_dtype if half else p.dtype)
        if stats is not None:
            variables.update(unflatten_to_tree(stats, self.stat_spec,
                                               stats.dtype))
        if self.augment is not None:     # its draws come before dropout's
            x = self.augment(generator, x)
        if x.is_floating_point():        # flax promotes x to the params'
            x = x.to(self.train_dtype if half else p.dtype)
        logits = functional_call(self.model, variables, (x,),
                                 {"train": True, "rng": generator})
        if half:
            logits = logits.float()      # the loss in f32
        y, mask = self._masks(y, mask, (self.train_ignore_id,))
        loss = LOSSES[self.loss_name](logits, y, mask)
        if self.prox_mu > 0.0 and global_params is not None:
            loss = loss + 0.5 * self.prox_mu * (
                p - global_params[:p.shape[0]]).square().sum()
        return loss

    # -- one step -----------------------------------------------------------
    def train_step(self, flat: torch.Tensor, batch: dict,
                   opt_state: Optional[dict] = None,
                   global_params: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None):
        """(new flat, new optimizer state, loss) after one step on `batch`;
        with no real sample in the batch the loss is 0 and the vector and
        the optimizer state (but a schedule's count) are unchanged.
        `opt_state` None starts from a fresh state."""
        if opt_state is None:
            opt_state = self.init_opt(flat)
        n_p, n = self.n_params, self.spec.n
        p = flat[:self.train_len].detach()
        stats = flat[n_p:n].clone() if self.n_stats else None
        leaf = p.detach().requires_grad_()
        loss = self._loss(leaf, stats, batch, global_params, generator)
        (grad,) = torch.autograd.grad(loss, leaf)
        has_data = batch["mask"].sum() > 0
        updates, new_state = self.tx.update(grad, opt_state, p)
        new = p + updates * has_data.to(p.dtype)
        if self.n_stats:
            new = torch.cat([new, torch.where(has_data, stats, flat[n_p:n]),
                             flat[n:]])
        return (new, self.tx.select(has_data, new_state, opt_state),
                torch.where(has_data, loss.detach(), torch.zeros_like(loss)))

    # -- local training -----------------------------------------------------
    def local_train(self, flat: torch.Tensor, shard: dict, epochs: int,
                    global_params: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None):
        """E local epochs over one client's padded shard ({"x": [B, bs,
        ...], "y": [B, bs, ...], "mask": [B, bs]}) from a fresh optimizer
        state.  Returns (new flat, mean over epochs of the sample-weighted
        epoch loss, number of real samples).  `global_params` is the
        round's global flat vector, read by the FedProx term; `generator`
        feeds augmentation and dropout."""
        n_batches = shard["mask"].shape[0]
        # the JAX trainer's span of this name fires once a trace (its body
        # runs under jit); in eager PyTorch it fires once a call, and
        # times the host's enqueue of the client's steps
        with obs.span("trace.local_train", epochs=epochs):
            opt_state = self.init_opt(flat)
            epoch_losses = []
            for _ in range(epochs):
                losses, counts = [], []
                for b in range(n_batches):
                    batch = {k: v[b] for k, v in shard.items()}
                    flat, opt_state, loss = self.train_step(
                        flat, batch, opt_state, global_params, generator)
                    losses.append(loss)
                    counts.append(batch["mask"].sum())
                losses, counts = torch.stack(losses), torch.stack(counts)
                # sample-weighted epoch loss: padding batches add nothing
                epoch_losses.append((losses * counts).sum()
                                    / torch.clamp(counts.sum(), min=1.0))
        return flat, torch.stack(epoch_losses).mean(), shard["mask"].sum()

    # -- eval ---------------------------------------------------------------
    @torch.no_grad()
    def eval_step(self, flat: torch.Tensor, batch: dict) -> dict:
        """Sums over one batch: loss_sum, correct, count (mask-aware), with
        BatchNorm on its running statistics."""
        x, y, mask = batch["x"], batch["y"], batch["mask"]
        if x.is_floating_point():
            x = x.to(flat.dtype)
        logits = functional_call(self.model, self.unflatten(flat), (x,)).float()
        y, mask = self._masks(y, mask, (self.eval_ignore_id,
                                        self.train_ignore_id))
        if self.loss_name == "bce":
            loss = sigmoid_binary_cross_entropy(logits, y).mean(dim=-1)
            # multi-label: a hit when the top predicted tag is present
            hit = y.gather(-1, logits.argmax(dim=-1)[..., None])[..., 0]
            return {"loss_sum": (loss * mask).sum(),
                    "correct": (hit * mask).sum(), "count": mask.sum()}
        ce = softmax_cross_entropy(logits, y)
        if self.loss_name == "focal":        # eval with the train criterion
            ce = focal_from_ce(ce)
        correct, count = masked_accuracy_sums(logits, y, mask)
        return {"loss_sum": (ce * mask).sum(), "correct": correct,
                "count": count}

    def evaluate(self, flat: torch.Tensor, shard: dict) -> dict:
        """eval_step summed over the batches of a padded shard (its span,
        like local_train's, fires once a call)."""
        sums = None
        with obs.span("trace.evaluate"):
            for b in range(shard["mask"].shape[0]):
                m = self.eval_step(flat, {k: v[b] for k, v in shard.items()})
                sums = m if sums is None else {k: sums[k] + m[k] for k in m}
        return sums
