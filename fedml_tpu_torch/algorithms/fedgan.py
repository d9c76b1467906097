"""FedGAN — federated GAN training, FedAvg over a (generator,
discriminator) pair (port of fedml_tpu/algorithms/fedgan.py,
single-device engine).

Parity: fedml_api/distributed/fedgan/ (FedGANAggregator.py:1-164,
MyModelTrainer.py:1-100): each client runs local adversarial steps, and
the server sample-weight-averages both nets.

Within a batch (``_batch_step``): a discriminator step on real and fake
samples, then a generator step against the UPDATED discriminator, each
with its own adam (created afresh for every client's local training);
an all-padding batch leaves both nets and states as they were.  The
latent z comes from each client's generator of the round
(``client_generator``) on the host, drawn on the CPU and moved to the
device, so the same seed gives the same z on any device; JAX draws
from ``jax.random``, so parity with JAX holds on a batch step given its z.
The clients run one after another; the mean of (G, D) over the cohort is
one fold-kernel launch (``ops.weighted_mean``) on the card.  The params
are one dict, the generator's leaves under ``gen.`` and the
discriminator's under ``disc.`` (the JAX engine's ``{"gen", "disc"}``
pair under dotted names).  The mesh variant (``make_mesh_fedgan_engine``)
is slice 6 of the port.
"""
from __future__ import annotations

import logging
import time
from typing import Callable, Optional

import torch

from fedml_tpu_torch.core.flatmodel import FlatModel
from fedml_tpu_torch.core.sampling import ClientSampler
from fedml_tpu_torch.core.trainer import (client_generator, make_optimizer,
                                          sigmoid_binary_cross_entropy)
from fedml_tpu_torch.data.federated import FederatedData
from fedml_tpu_torch.ops.aggregate import weighted_mean
from fedml_tpu_torch.utils.config import FedConfig
from fedml_tpu_torch.utils.device import resolve_device

log = logging.getLogger(__name__)


def _bce_logits(logits: torch.Tensor, target_ones: bool, mask: torch.Tensor):
    y = torch.ones_like(logits) if target_ones else torch.zeros_like(logits)
    ls = sigmoid_binary_cross_entropy(logits, y)
    m = mask.to(ls.dtype)
    return (ls * m).sum() / torch.clamp(m.sum(), min=1.0)


class FedGANEngine:
    def __init__(self, generator, discriminator, data: FederatedData,
                 cfg: FedConfig, latent_dim: int = 64, device=None):
        self.device = resolve_device(device)
        self.gen = FlatModel(generator)
        self.disc = FlatModel(discriminator)
        self.data = data
        self.cfg = cfg
        self.latent_dim = latent_dim
        self.g_tx = make_optimizer("adam", cfg.lr)
        self.d_tx = make_optimizer("adam", cfg.lr)
        self.sampler = ClientSampler.for_data(data, cfg)
        self.metrics_history: list[dict] = []

    def init_params(self, generator: Optional[torch.Generator] = None) -> dict:
        if generator is None:
            generator = torch.Generator().manual_seed(self.cfg.seed)
        gp = self.gen.init(generator, self.device)
        dp = self.disc.init(generator, self.device)
        return {**{f"gen.{k}": v for k, v in gp.items()},
                **{f"disc.{k}": v for k, v in dp.items()}}

    def _split(self, params: dict) -> tuple[torch.Tensor, torch.Tensor]:
        """params -> (generator vector, discriminator vector)."""
        part = lambda pre: {k[len(pre):]: v for k, v in params.items()
                            if k.startswith(pre)}
        return (self.gen.flatten(part("gen.")),
                self.disc.flatten(part("disc.")))

    def _join(self, g: torch.Tensor, d: torch.Tensor) -> dict:
        return {**{f"gen.{k}": v for k, v in self.gen.unflatten(g).items()},
                **{f"disc.{k}": v for k, v in self.disc.unflatten(d).items()}}

    def _batch_step(self, g, d, g_opt, d_opt, batch: dict, z1: torch.Tensor,
                    z2: torch.Tensor):
        """One adversarial step on `batch` given the D step's z (`z1`) and
        the G step's (`z2`): (g, d, g_opt, d_opt, d_loss, g_loss)."""
        m = batch["mask"]
        has = m.sum() > 0
        fake = self.gen(g, z1).detach()
        d_leaf = d.detach().requires_grad_()
        d_loss = (_bce_logits(self.disc(d_leaf, batch["x"]), True, m)
                  + _bce_logits(self.disc(d_leaf, fake), False, m))
        (dg,) = torch.autograd.grad(d_loss, d_leaf)
        du, d_new = self.d_tx.update(dg, d_opt, d)
        new_d = d + du
        # G step: fool the UPDATED discriminator
        g_leaf = g.detach().requires_grad_()
        g_loss = _bce_logits(self.disc(new_d, self.gen(g_leaf, z2)), True, m)
        (gg,) = torch.autograd.grad(g_loss, g_leaf)
        gu, g_new = self.g_tx.update(gg, g_opt, g)
        return (torch.where(has, g + gu, g), torch.where(has, new_d, d),
                self.g_tx.select(has, g_new, g_opt),
                self.d_tx.select(has, d_new, d_opt),
                d_loss.detach(), g_loss.detach())

    def _local_train(self, g, d, shard: dict, draw_z: Callable):
        """Alternating D/G steps over the client's batches x epochs
        (MyModelTrainer.train's inner loop); `draw_z(n)` gives n latent
        rows.  Returns (g, d, mean d_loss, mean g_loss, real samples)."""
        g_opt, d_opt = self.g_tx.init(g), self.d_tx.init(d)
        dls, gls = [], []
        for _ in range(self.cfg.epochs):
            ed, eg = [], []
            for b in range(shard["mask"].shape[0]):
                batch = {k: v[b] for k, v in shard.items()}
                bs = batch["x"].shape[0]
                z1, z2 = draw_z(bs), draw_z(bs)
                g, d, g_opt, d_opt, dl, gl = self._batch_step(
                    g, d, g_opt, d_opt, batch, z1, z2)
                ed.append(dl)
                eg.append(gl)
            dls.append(torch.stack(ed).mean())
            gls.append(torch.stack(eg).mean())
        return (g, d, torch.stack(dls).mean(), torch.stack(gls).mean(),
                shard["mask"].sum())

    def _draw(self, round_idx: int, client: int) -> Callable:
        host = client_generator(self.cfg.seed, round_idx, client, "cpu")
        return lambda n: torch.randn(n, self.latent_dim,
                                     generator=host).to(self.device)

    def _round(self, params: dict, cohort: dict, round_idx: int):
        g0, d0 = self._split(params)
        rows, dls, gls, ns = {}, [], [], []
        for i in range(cohort["mask"].shape[0]):
            g, d, dl, gl, n = self._local_train(
                g0, d0, {k: t[i] for k, t in cohort.items()},
                self._draw(round_idx, i))
            for k, v in self._join(g, d).items():
                rows.setdefault(k, []).append(v)
            dls.append(dl)
            gls.append(gl)
            ns.append(n)
        # G and D both averaged: one fold of the whole pair
        new = weighted_mean({k: torch.stack(v) for k, v in rows.items()},
                            torch.stack(ns))
        return new, {"d_loss": torch.stack(dls).mean(),
                     "g_loss": torch.stack(gls).mean()}

    round_fn = _round

    def run(self, rounds: Optional[int] = None,
            params: Optional[dict] = None) -> dict:
        cfg = self.cfg
        params = params if params is not None else self.init_params()
        rounds = rounds if rounds is not None else cfg.comm_round
        for round_idx in range(rounds):
            t0 = time.time()
            cohort, _ = self.data.cohort(self.sampler.sample(round_idx),
                                         self.device)
            params, m = self.round_fn(params, cohort, round_idx)
            stats = {"round": round_idx, "d_loss": float(m["d_loss"]),
                     "g_loss": float(m["g_loss"]),
                     "round_time": time.time() - t0}
            self.metrics_history.append(stats)
            log.info("fedgan round %d: %s", round_idx, stats)
        return params

    @torch.no_grad()
    def generate(self, params: dict, n: int,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        generator = generator or torch.Generator().manual_seed(0)
        z = torch.randn(n, self.latent_dim, generator=generator).to(self.device)
        return self.gen(self._split(params)[0], z)
