"""FedNAS, federated neural architecture search with DARTS (port of
fedml_tpu/algorithms/fednas.py, single-device engines).

Reference: fedml_api/distributed/fednas/{FedNASTrainer.py:34-128,
FedNASAggregator.py:71-113}.  Each client alternates an architecture
(alpha) step on a validation batch with a weight (w) step on a train
batch; the server averages w and the alphas with the same sample
weights; after the search the strongest genotype is derived and
retrained with FedAvg (``make_train_engine``).

The parameters of the supernet are one flat f32 vector (``FlatModel``),
the alphas another ([k, O] for normal cells, then [k, O] for reduction
cells).  A client's search runs on the engine's device, clients one after
another (the JAX engine vmaps them); the server's mean folds each client's
[w | alphas] row through the fold kernel's finalize form
(``ops.aggregate.weighted_mean_flat``): one launch a round.

Where the parity with the JAX engine is not obvious:
* the batch stream splits interleaved, even batches to train w and odd
  ones to drive the alpha step (``_local_search``, JAX :136-146); a
  client with a single batch uses it for both (single-level search);
* the alpha step is gated on the VALIDATION batch's mask, the w step on
  the train batch's; a gated-off step keeps its optimizer state too; the
  w step uses the alphas the alpha step just produced;
* the exact second-order architect (``unrolled=True``) differentiates
  grad_alpha L_val(w - eta * grad_w L_train(w, alpha), alpha), eta the
  client lr, with ``torch.autograd.grad(create_graph=True)``: the
  GroupNorm op's backward is differentiable (``ops/groupnorm.py``), so
  the kernels run inside the second-order graph;
* the w optimizer is optax's chain(clip_by_global_norm(5),
  add_decayed_weights(3e-4), sgd(lr, momentum=0.9)), the alpha optimizer
  chain(add_decayed_weights(1e-3), scale_by_adam(b1=0.5, b2=0.999),
  scale(-3e-4)): the published DARTS values (``core/trainer.py::
  Optimizer`` with clip_norm, b1, b2);
* GDAS draws its Gumbel uniforms from each client's generator on the
  host (``client_generator(seed, round, client, "cpu")``) and moves them
  to the device, so the card and the CPU see the same noise; JAX draws
  from its keys, so parity holds given JAX's uniforms.  GDAS evaluates
  the argmax one-hot architecture.
The mesh variant (``make_mesh_fednas_engine``) belongs to slice 6 of the
port.
"""
from __future__ import annotations

import logging
import time
from typing import Optional

import torch
import torch.nn.functional as F

from fedml_tpu_torch import obs
from fedml_tpu_torch.algorithms.fedavg import FedAvgEngine
from fedml_tpu_torch.core.flatmodel import FlatModel
from fedml_tpu_torch.core.sampling import ClientSampler
from fedml_tpu_torch.core.trainer import (ClientTrainer, Optimizer,
                                          client_generator,
                                          masked_cross_entropy,
                                          softmax_cross_entropy)
from fedml_tpu_torch.data.federated import FederatedData
from fedml_tpu_torch.models.darts import (PRIMITIVES, DartsNetwork,
                                          DartsSearchNetwork, derive_genotype,
                                          gumbel_uniform, init_alphas,
                                          num_edges, st_gumbel_softmax)
from fedml_tpu_torch.ops.aggregate import weighted_mean_flat
from fedml_tpu_torch.utils.config import FedConfig
from fedml_tpu_torch.utils.device import resolve_device, to_device

log = logging.getLogger(__name__)


def _batch(shard: dict, b: int) -> dict:
    return {k: v[b] for k, v in shard.items()}


class FedNASSearchEngine:
    """The search phase: federated bilevel optimization of (w, alphas) on
    one device (CUDA unless `device` names another)."""

    def __init__(self, data: FederatedData, cfg: FedConfig,
                 num_classes: Optional[int] = None, C: int = 16,
                 layers: int = 8, steps: int = 4, multiplier: int = 4,
                 unrolled: bool = False, gdas: bool = False,
                 gdas_tau: float = 1.0, arch_lr: float = 3e-4,
                 arch_weight_decay: float = 1e-3, momentum: float = 0.9,
                 weight_decay: float = 3e-4, grad_clip: float = 5.0,
                 device=None):
        self.device = resolve_device(device)
        self.data = data
        self.cfg = cfg
        self.steps = steps
        self.multiplier = multiplier
        self.gdas = gdas
        self.gdas_tau = gdas_tau
        self.net = FlatModel(DartsSearchNetwork(
            num_classes=num_classes or data.class_num, C=C, layers=layers,
            steps=steps, multiplier=multiplier, softmax_weights=not gdas))
        self.n_edges = num_edges(steps)
        self.unrolled = unrolled
        self.eta = cfg.lr                       # the unroll's inner lr
        # w: SGD + momentum + weight decay after a global-norm clip
        # (FedNASTrainer.py:66-71); alphas: Adam(3e-4, b=(0.5, 0.999)),
        # wd 1e-3 (FedNASTrainer.py:73-76)
        self.w_tx = Optimizer("sgd", cfg.lr, momentum, weight_decay,
                              clip_norm=grad_clip)
        self.a_tx = Optimizer("adam", arch_lr, weight_decay=arch_weight_decay,
                              b1=0.5, b2=0.999)
        self.sampler = ClientSampler.for_data(data, cfg)
        self._test_shard = to_device(data.test_global, self.device)
        self.metrics_history: list[dict] = []

    # -- state ---------------------------------------------------------------
    def init_state(self, generator: Optional[torch.Generator] = None):
        """(params {name: tensor}, alphas {"normal", "reduce"}) on the
        engine's device, drawn on the CPU from `generator` (default: seeded
        with cfg.seed): the alphas first, then the weights."""
        if generator is None:
            generator = torch.Generator().manual_seed(self.cfg.seed)
        alphas = init_alphas(generator, self.steps, self.device)
        return self.net.init(generator, self.device), alphas

    def flatten_alphas(self, alphas: dict) -> torch.Tensor:
        return torch.cat([alphas["normal"].reshape(-1),
                          alphas["reduce"].reshape(-1)])

    def unflatten_alphas(self, a: torch.Tensor) -> dict:
        normal, reduce = a.view(2, self.n_edges, len(PRIMITIVES)).unbind(0)
        return {"normal": normal, "reduce": reduce}

    # -- losses --------------------------------------------------------------
    def _draw_noise(self, generator: torch.Generator) -> torch.Tensor:
        """GDAS: the uniforms of one mix's Gumbel noise, [2, k, O] (normal,
        then reduce), drawn on the host generator and moved to the
        device."""
        return gumbel_uniform((2, self.n_edges, len(PRIMITIVES)),
                              generator).to(self.device)

    def _mix(self, a: torch.Tensor, noise: Optional[torch.Tensor]) -> dict:
        alphas = self.unflatten_alphas(a)
        if not self.gdas:
            return alphas
        return {kind: st_gumbel_softmax(alphas[kind], u, self.gdas_tau)
                for kind, u in zip(("normal", "reduce"), noise)}

    def _loss(self, p: torch.Tensor, a: torch.Tensor, batch: dict,
              noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        logits = self.net(p, batch["x"], self._mix(a, noise))
        return masked_cross_entropy(logits, batch["y"], batch["mask"])

    def _arch_grad(self, p: torch.Tensor, a: torch.Tensor, train_batch: dict,
                   val_batch: dict,
                   noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """grad_alpha of the validation loss: first order at w
        (architect.py step_single_level), or exactly through the unrolled
        step w' = w - eta * grad_w L_train(w, alpha)."""
        a = a.detach().requires_grad_()
        if not self.unrolled:
            loss = self._loss(p.detach(), a, val_batch, noise)
            return torch.autograd.grad(loss, a)[0]
        w = p.detach().requires_grad_()
        (gw,) = torch.autograd.grad(self._loss(w, a, train_batch, noise), w,
                                    create_graph=True)
        loss = self._loss(w - self.eta * gw, a, val_batch, noise)
        return torch.autograd.grad(loss, a)[0]

    # -- one client's local search -------------------------------------------
    def _local_search(self, p: torch.Tensor, a: torch.Tensor, shard: dict,
                      epochs: int, generator: torch.Generator):
        """`epochs` over one client's padded shard ({x, y, mask} [B, bs,
        ...]) from fresh optimizer states: (new w, new alphas, mean over
        epochs of the sample-weighted epoch loss, the shard's real
        samples)."""
        B = shard["mask"].shape[0]
        half = B // 2
        if half > 0:        # interleaved, so padding batches split evenly
            train = {k: v[0::2][:half] for k, v in shard.items()}
            val = {k: v[1::2][:half] for k, v in shard.items()}
        else:               # a single batch: single-level search
            train = val = shard
        n_samples = shard["mask"].sum()
        w_opt, a_opt = self.w_tx.init(p), self.a_tx.init(a)
        epoch_losses = []
        for _ in range(epochs):
            losses, counts = [], []
            for b in range(train["mask"].shape[0]):
                tb, vb = _batch(train, b), _batch(val, b)
                noise_a = self._draw_noise(generator) if self.gdas else None
                noise_w = self._draw_noise(generator) if self.gdas else None
                has_data = tb["mask"].sum() > 0
                has_val = vb["mask"].sum() > 0
                # alpha step on the val batch, gated on the val batch: an
                # empty one must not turn it into Adam-scaled weight decay
                ga = self._arch_grad(p, a, tb, vb, noise_a)
                ua, a_opt2 = self.a_tx.update(ga, a_opt, a)
                a = torch.where(has_val, a + ua, a)
                a_opt = self.a_tx.select(has_val, a_opt2, a_opt)
                # w step on the train batch, with the updated alphas
                leaf = p.detach().requires_grad_()
                loss = self._loss(leaf, a, tb, noise_w)
                (gw,) = torch.autograd.grad(loss, leaf)
                uw, w_opt2 = self.w_tx.update(gw, w_opt, p)
                p = torch.where(has_data, p + uw, p)
                w_opt = self.w_tx.select(has_data, w_opt2, w_opt)
                losses.append(torch.where(has_data, loss.detach(),
                                          torch.zeros_like(loss)))
                counts.append(tb["mask"].sum())
            losses, counts = torch.stack(losses), torch.stack(counts)
            epoch_losses.append((losses * counts).sum()
                                / torch.clamp(counts.sum(), min=1.0))
        return p, a, torch.stack(epoch_losses).mean(), n_samples

    # -- one federated round -------------------------------------------------
    def round_fn(self, p: torch.Tensor, a: torch.Tensor, cohort: dict,
                 round_idx: int = 0):
        """Every client's local search from the global (w, alphas), then
        the sample-weighted mean of both as one [w | alphas] row per
        client: (new w, new alphas, {"train_loss"})."""
        rows, losses, ns = [], [], []
        for i in range(cohort["mask"].shape[0]):
            gen = client_generator(self.cfg.seed, round_idx, i, "cpu")
            pi, ai, loss, n = self._local_search(
                p, a, {k: v[i] for k, v in cohort.items()}, self.cfg.epochs,
                gen)
            rows.append(torch.cat([pi, ai]))
            losses.append(loss)
            ns.append(n)
        losses, ns = torch.stack(losses), torch.stack(ns).float()
        mean = weighted_mean_flat(torch.stack(rows), ns.contiguous())
        train_loss = (losses * ns).sum() / torch.clamp(ns.sum(), min=1.0)
        return mean[:p.shape[0]], mean[p.shape[0]:], {"train_loss": train_loss}

    # -- evaluation ----------------------------------------------------------
    @torch.no_grad()
    def eval_sums(self, p: torch.Tensor, a: torch.Tensor, shard: dict) -> dict:
        """Summed CE, correct and count over a padded shard's batches; GDAS
        evaluates the argmax one-hot architecture."""
        alphas = self.unflatten_alphas(a)
        if self.gdas:
            alphas = {k: F.one_hot(v.argmax(dim=-1), v.shape[-1]).to(v.dtype)
                      for k, v in alphas.items()}
        sums = {"loss": 0.0, "correct": 0.0, "count": 0.0}
        for b in range(shard["mask"].shape[0]):
            batch = _batch(shard, b)
            logits = self.net(p, batch["x"], alphas)
            m = batch["mask"]
            ce = softmax_cross_entropy(logits, batch["y"])
            ok = (logits.argmax(dim=-1) == batch["y"]).float() * m
            sums = {"loss": sums["loss"] + (ce * m).sum(),
                    "correct": sums["correct"] + ok.sum(),
                    "count": sums["count"] + m.sum()}
        return sums

    def evaluate(self, params: dict, alphas: dict) -> dict:
        s = self.eval_sums(self.net.flatten(params), self.flatten_alphas(alphas),
                           self._test_shard)
        n = max(float(s["count"]), 1.0)
        return {"test_loss": float(s["loss"]) / n,
                "test_acc": float(s["correct"]) / n}

    # -- the run loop --------------------------------------------------------
    def _round_args(self, round_idx: int) -> tuple:
        cohort, _ = self.data.cohort(self.sampler.sample(round_idx),
                                     self.device)
        return cohort, round_idx

    def run(self, rounds: Optional[int] = None, params: Optional[dict] = None,
            alphas: Optional[dict] = None):
        """The search loop: `rounds` (default cfg.comm_round) rounds from
        (params, alphas) (default init_state()), an evaluation every
        frequency_of_the_test rounds and after the last; returns (params,
        alphas)."""
        cfg = self.cfg
        if params is None or alphas is None:
            params, alphas = self.init_state()
        p, a = self.net.flatten(params), self.flatten_alphas(alphas)
        rounds = rounds if rounds is not None else cfg.comm_round
        for round_idx in range(rounds):
            t0 = time.time()
            with obs.span("round", round=round_idx, engine="FedNASSearchEngine"):
                p, a, m = self.round_fn(p, a, *self._round_args(round_idx))
            if (round_idx % cfg.frequency_of_the_test == 0
                    or round_idx == rounds - 1):
                with obs.span("eval", round=round_idx):
                    stats = self.evaluate(self.net.unflatten(p),
                                          self.unflatten_alphas(a))
                stats.update(round=round_idx, train_loss=float(m["train_loss"]),
                             round_time=time.time() - t0)
                self.metrics_history.append(stats)
                log.info("fednas search %s", stats)
        return self.net.unflatten(p), self.unflatten_alphas(a)

    def genotype(self, alphas: dict):
        return derive_genotype(alphas, steps=self.steps,
                               multiplier=self.multiplier)


def make_train_engine(genotype, data: FederatedData, cfg: FedConfig,
                      C: int = 36, layers: int = 20, device=None,
                      **kw) -> FedAvgEngine:
    """The train phase: FedAvg over the derived DartsNetwork (the
    reference's post-search stage, CI-script-fednas.sh), with SGD at the
    config's lr, momentum 0.9 and weight decay 3e-4."""
    model = DartsNetwork(num_classes=data.class_num, genotype=genotype, C=C,
                         layers=layers)
    trainer = ClientTrainer(model, lr=cfg.lr, momentum=0.9, weight_decay=3e-4)
    return FedAvgEngine(trainer, data, cfg, device=device, **kw)
