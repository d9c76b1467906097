"""ClientTrainer: the main-path subset of fedml_tpu/core/trainer.py.

The JAX trainer is a set of pure functions over a variables pytree.  Here
a client's variables travel as ONE flat vector in the layout of
``trainer.spec`` (the model's parameters in module order, padded with zeros
to a multiple of 512 elements, as ``ops.aggregate`` pads its rows): the
SGD update is then one elementwise pass over the vector, and the mesh
engine's chunk fold reads trained clients as the rows of a [k, P] matrix
without copying leaves together.  ``flatten``/``unflatten`` convert to and
from ``{name: tensor}`` dicts.

Parity with the JAX trainer, where it is not obvious:
* ``train_dtype=torch.bfloat16`` casts params and x to bf16 for the
  forward/backward and casts the logits to f32 before the loss
  (trainer.py:257-275).
* The update is ``u = -lr * g`` rounded to the params' dtype, then
  ``p + u`` rounded again: optax's two roundings, not a fused ``add_``;
  lr itself is first rounded to that dtype, as optax's weakly typed
  scalar is.
* An all-padding batch scales the update by ``has_data`` = 0 and reports
  loss 0 (trainer.py:336-349).
* FedProx: with ``prox_mu`` > 0 and the round's global vector passed as
  ``global_params``, the loss gains (mu/2) * ||p - g||^2 over the
  parameters (trainer.py:298-308); the zero pad tail adds nothing.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.func import functional_call

from fedml_tpu_torch.models import init_params
from fedml_tpu_torch.ops.aggregate import spec_of, unflatten_to_tree
from fedml_tpu_torch.utils.device import resolve_device


def masked_cross_entropy(logits, labels, mask):
    """Mean softmax CE over valid (mask=1) samples; labels are class ids."""
    ce = torch.logsumexp(logits, dim=-1) \
        - logits.gather(-1, labels[..., None].long())[..., 0]
    mask = mask.to(ce.dtype)
    return (ce * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def masked_accuracy_sums(logits, labels, mask):
    """(n_correct, n_valid) so accuracies aggregate exactly across clients
    and batches."""
    ok = (logits.argmax(dim=-1) == labels).float() * mask.float()
    return ok.sum(), mask.float().sum()


def _in_dtype(value: float, dtype) -> float:
    """`value` rounded to `dtype`: a Python scalar in a JAX op with a bf16
    array is weakly typed and becomes bf16 first (lr 0.1 is 0.10009765625
    there), where PyTorch would keep it in f32."""
    return torch.tensor(value, dtype=dtype).item()


class SGD:
    """optax ``chain(add_decayed_weights(wd), sgd(lr))`` without momentum,
    on flat tensors: u = -lr * (g + wd * p), each op rounded to g's dtype,
    and lr and wd rounded to it first, as optax's weakly typed scalars
    are."""

    def __init__(self, lr: float, weight_decay: float = 0.0):
        self.lr = float(lr)
        self.weight_decay = float(weight_decay)

    def update(self, grads: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
        if self.weight_decay:
            grads = grads + _in_dtype(self.weight_decay, grads.dtype) * params
        return _in_dtype(-self.lr, grads.dtype) * grads


def make_optimizer(name: str, lr, momentum: float = 0.0,
                   weight_decay: float = 0.0) -> SGD:
    """Client optimizer factory; the port has plain SGD (with optional
    decoupled weight decay) so far."""
    if name != "sgd" or momentum or callable(lr):
        raise ValueError(
            f"optimizer {name!r} with momentum={momentum} and lr={lr!r} is "
            "not ported yet: the port has plain SGD at a constant lr")
    return SGD(lr, weight_decay)


class ClientTrainer:
    """Train/eval operator for one model, over flat parameter vectors.

    Args:
      model: an nn.Module; its own parameters are only the layout template
        (every call substitutes the flat vector's views).
      loss: "ce" (the only loss ported so far).
      optimizer / lr / momentum / weight_decay: client-side SGD config.
      train_dtype: compute dtype of the training forward/backward.
      prox_mu: FedProx proximal coefficient; when > 0, local_train takes
        the round's global flat vector and adds (mu/2)||p - g||^2.
    """

    def __init__(self, model: nn.Module, loss: str = "ce",
                 optimizer: str = "sgd", lr=0.03, momentum: float = 0.0,
                 weight_decay: float = 0.0, train_dtype=torch.float32,
                 prox_mu: float = 0.0):
        if loss != "ce":
            raise ValueError(f"loss {loss!r} is not ported yet (only 'ce')")
        self.model = model
        self.tx = make_optimizer(optimizer, lr, momentum, weight_decay)
        self.prox_mu = prox_mu
        self.train_dtype = train_dtype
        self.spec = spec_of(dict(model.named_parameters()))

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

    # -- loss ---------------------------------------------------------------
    def _loss(self, flat: torch.Tensor, batch: dict,
              global_params: torch.Tensor | None = None) -> torch.Tensor:
        x, y, mask = batch["x"], batch["y"], batch["mask"]
        half = self.train_dtype != torch.float32
        params = self.unflatten(flat, self.train_dtype if half else None)
        if half and x.is_floating_point():
            x = x.to(self.train_dtype)
        logits = functional_call(self.model, params, (x,)).float()
        loss = masked_cross_entropy(logits, y, mask)
        if self.prox_mu > 0.0 and global_params is not None:
            loss = loss + 0.5 * self.prox_mu * (flat - global_params).square().sum()
        return loss

    # -- one SGD step -------------------------------------------------------
    def train_step(self, flat: torch.Tensor, batch: dict,
                   global_params: torch.Tensor | None = None):
        """(new flat, loss) after one SGD step on `batch`; the loss is 0 and
        the params unchanged when the batch holds no real sample."""
        leaf = flat.detach().requires_grad_()
        loss = self._loss(leaf, batch, global_params)
        (grad,) = torch.autograd.grad(loss, leaf)
        has_data = batch["mask"].sum() > 0
        flat = flat.detach()
        updates = self.tx.update(grad, flat) * has_data.to(flat.dtype)
        return flat + updates, torch.where(has_data, loss.detach(),
                                           torch.zeros_like(loss))

    # -- local training -----------------------------------------------------
    def local_train(self, flat: torch.Tensor, shard: dict, epochs: int,
                    global_params: torch.Tensor | None = None):
        """E local epochs of SGD over one client's padded shard
        ({"x": [B, bs, ...], "y": [B, bs], "mask": [B, bs]}).  Returns
        (new flat, mean over epochs of the sample-weighted epoch loss,
        number of real samples).  `global_params` is the round's global
        flat vector, read by the FedProx term."""
        n_batches = shard["mask"].shape[0]
        epoch_losses = []
        for _ in range(epochs):
            losses, counts = [], []
            for b in range(n_batches):
                batch = {k: v[b] for k, v in shard.items()}
                flat, loss = self.train_step(flat, batch, global_params)
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
        """Sums over one batch: loss_sum, correct, count (mask-aware)."""
        x, y, mask = batch["x"], batch["y"], batch["mask"]
        if x.is_floating_point():
            x = x.to(flat.dtype)
        logits = functional_call(self.model, self.unflatten(flat), (x,)).float()
        ce = torch.logsumexp(logits, dim=-1) - logits.gather(-1, y[..., None])[..., 0]
        correct, count = masked_accuracy_sums(logits, y, mask)
        return {"loss_sum": (ce * mask).sum(), "correct": correct,
                "count": count}

    def evaluate(self, flat: torch.Tensor, shard: dict) -> dict:
        """eval_step summed over the batches of a padded shard."""
        sums = None
        for b in range(shard["mask"].shape[0]):
            m = self.eval_step(flat, {k: v[b] for k, v in shard.items()})
            sums = m if sums is None else {k: sums[k] + m[k] for k in m}
        return sums
