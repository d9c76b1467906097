"""FedGKT — group knowledge transfer, split training through distillation
(port of fedml_tpu/algorithms/fedgkt.py, single-device engine).

Parity: fedml_api/distributed/fedgkt/: the client runs a small CNN and
uploads per-sample feature maps, logits and labels
(GKTClientTrainer.py:49-129); the server trains a large CNN on those
features with CE + KL distillation toward the client logits
(GKTServerTrainer.py:42-48, 193-291, ``KL_Loss(temperature)`` in
utils.py), then returns its own logits per client for the client's next
local phase.

A round here, on the engine's device:
1. every client in turn trains its own copy of the client net for
   `epochs` over its shard (CE, plus KL toward the server's last logits
   for the batch once any of them is nonzero: round 0's are zeros, so
   its loss is pure CE), then uploads features and logits for every
   sample: [C, B, bs, H, W, 16] f32 features, kept on the device;
2. the server trains one distillation epoch (of `server_epochs`) over the
   flattened client x batch stream, an all-padding step frozen and left
   out of the epoch's mean loss;
3. the server's logits for every uploaded batch go back to the clients.
The two nets are flat vectors (``core/flatmodel.py``) stepped by the
port's optax-equivalent ``Optimizer``: the client's from the config, the
server's SGD with momentum 0.9 and weight decay 1e-4 at the client lr by
default (GKTServerTrainer.py:39-44).  The JAX engine vmaps the clients
and scans the steps; here they run one after another.

``MeshFedGKTEngine`` (fedgkt.py:229-313) runs a round over a mesh of
ranks on two axes, one a phase: the client phase splits the clients over
the ranks (the stack padded with zero-mask clients, ``pad_cohort``), and
the server phase splits each distillation step's BATCH over them (the
reference's one classic-DP use, ``nn.DataParallel`` on the GKT server,
GKTServerTrainer.py:27-29): the batch axis is padded with mask-0 samples
to a multiple of the ranks, every rank's loss is its rows' share c_l /
max(c_g, 1) of the unsplit batch's, and ONE host fold of [gradient |
loss] a step in rank order gives every rank the same update.  Between
the phases every rank gathers the client phase's features and logits
(JAX's in-program all-to-all) and slices its batch rows; each rank
computes the next round's server logits for its own clients.  ``run``
returns the real clients only.
"""
from __future__ import annotations

import logging
import time
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from fedml_tpu_torch.core.flatmodel import FlatModel
from fedml_tpu_torch.core.trainer import (make_optimizer, masked_accuracy_sums,
                                          masked_cross_entropy)
from fedml_tpu_torch.data.federated import FederatedData
from fedml_tpu_torch.utils.config import FedConfig
from fedml_tpu_torch.utils.device import resolve_device, to_device

log = logging.getLogger(__name__)


def kl_divergence_loss(student_logits: torch.Tensor,
                       teacher_logits: torch.Tensor, mask: torch.Tensor,
                       temperature: float = 3.0) -> torch.Tensor:
    """KL(teacher || student) with temperature scaling (fedgkt/utils.py
    KL_Loss): T^2 * sum t * (log clip(t, 1e-8) - log_softmax(s / T)),
    t = softmax(teacher / T), averaged over the masked samples."""
    t = torch.softmax(teacher_logits / temperature, dim=-1)
    s = F.log_softmax(student_logits / temperature, dim=-1)
    per = (t * (torch.log(torch.clamp(t, min=1e-8)) - s)).sum(dim=-1)
    m = mask.to(per.dtype)
    return temperature ** 2 * (per * m).sum() / torch.clamp(m.sum(), min=1.0)


def _step(tx, flat: torch.Tensor, opt_state: dict, loss_fn, has):
    """One optimizer step of `flat` on loss_fn(flat); with no real sample
    (`has` false) the vector and the optimizer state stay as they were."""
    leaf = flat.detach().requires_grad_()
    loss = loss_fn(leaf)
    (grad,) = torch.autograd.grad(loss, leaf)
    updates, new_state = tx.update(grad, opt_state, flat)
    return (torch.where(has, flat + updates, flat),
            tx.select(has, new_state, opt_state), loss.detach())


class FedGKTEngine:
    """client_model: x -> (features, logits); server_model: features ->
    logits."""

    def __init__(self, client_model, server_model, data: FederatedData,
                 cfg: FedConfig, temperature: float = 3.0,
                 server_epochs: int = 1, server_optimizer: Optional[str] = None,
                 server_lr: Optional[float] = None,
                 server_momentum: float = 0.9, server_wd: float = 1e-4,
                 device=None):
        self.device = resolve_device(device)
        self.client = FlatModel(client_model)
        self.server = FlatModel(server_model)
        self.data = data
        self.cfg = cfg
        self.temperature = temperature
        self.server_epochs = server_epochs
        self.client_tx = make_optimizer(cfg.client_optimizer, cfg.lr,
                                        cfg.momentum, cfg.wd)
        # the GKT server optimizer trains the big model at the client lr
        # with momentum 0.9 and wd 1e-4 (GKTServerTrainer.py:39-44), not at
        # FedOpt's pseudo-gradient server_lr
        self.server_tx = make_optimizer(
            server_optimizer or cfg.client_optimizer,
            cfg.lr if server_lr is None else server_lr,
            server_momentum, weight_decay=server_wd)
        self.metrics_history: list[dict] = []

    # -- init ----------------------------------------------------------------
    def init_params(self, generator: Optional[torch.Generator] = None):
        """(client params, server params), {name: tensor} each."""
        if generator is None:
            generator = torch.Generator().manual_seed(self.cfg.seed)
        return (self.client.init(generator, self.device),
                self.server.init(generator, self.device))

    # -- client phase: local CE + KL(server logits) --------------------------
    def _client_loss(self, p: torch.Tensor, batch: dict, slog: torch.Tensor):
        _, logits = self.client(p, batch["x"])
        ce = masked_cross_entropy(logits, batch["y"], batch["mask"])
        kl = kl_divergence_loss(logits, slog, batch["mask"], self.temperature)
        use_kl = (slog.abs() > 0).any()
        return ce + torch.where(use_kl, kl, torch.zeros_like(kl))

    def _client_phase(self, p: torch.Tensor, shard: dict,
                      server_logits: torch.Tensor):
        """One client's `epochs` over its shard ({x, y, mask} [B, bs, ...])
        against the server's logits [B, bs, classes], then its upload:
        (client vector, features [B, bs, ...], logits [B, bs, classes],
        mean loss)."""
        opt = self.client_tx.init(p)
        n_batches = shard["mask"].shape[0]
        epoch_losses = []
        for _ in range(self.cfg.epochs):
            losses = []
            for b in range(n_batches):
                batch = {k: v[b] for k, v in shard.items()}
                p, opt, loss = _step(
                    self.client_tx, p, opt,
                    lambda q: self._client_loss(q, batch, server_logits[b]),
                    batch["mask"].sum() > 0)
                losses.append(loss)
            epoch_losses.append(torch.stack(losses).mean())
        # upload: features and logits for every sample (extracted_feature_
        # dict / logits_dict, GKTClientTrainer.py:49-129)
        with torch.no_grad():
            feats, logits = zip(*(self.client(p, shard["x"][b])
                                  for b in range(n_batches)))
        return (p, torch.stack(feats), torch.stack(logits),
                torch.stack(epoch_losses).mean())

    # -- server phase: distill on the uploaded features -----------------------
    def _server_loss(self, p, f, clog, y, m):
        slog = self.server(p, f)
        return (masked_cross_entropy(slog, y, m)
                + kl_divergence_loss(slog, clog, m, self.temperature))

    def _server_phase(self, sp: torch.Tensor, opt_state: dict,
                      feats: torch.Tensor, logits: torch.Tensor,
                      ys: torch.Tensor, masks: torch.Tensor):
        """`server_epochs` over the client x batch stream of the uploads
        (leading axes [K, B]; GKTServerTrainer.train_and_distill_on_server,
        :193-291), then the server's logits for every uploaded batch:
        (server vector, optimizer state, logits [K, B, bs, classes], mean
        epoch loss)."""
        K, B = masks.shape[:2]
        fl = lambda a: a.reshape((K * B,) + a.shape[2:])
        f_s, c_s, y_s, m_s = fl(feats), fl(logits), fl(ys), fl(masks)
        # all-padding steps are frozen and left out of the epoch's mean
        real = (m_s.sum(dim=1) > 0).float()
        epoch_losses = []
        for _ in range(self.server_epochs):
            losses = []
            for i in range(K * B):
                sp, opt_state, loss = _step(
                    self.server_tx, sp, opt_state,
                    lambda q: self._server_loss(q, f_s[i], c_s[i], y_s[i],
                                                m_s[i]),
                    real[i] > 0)
                losses.append(loss)
            epoch_losses.append((torch.stack(losses) * real).sum()
                                / torch.clamp(real.sum(), min=1.0))
        with torch.no_grad():
            slog = torch.stack([self.server(sp, f_s[i]) for i in range(K * B)])
        return (sp, opt_state, slog.reshape((K, B) + slog.shape[1:]),
                torch.stack(epoch_losses).mean())

    # -- one round ------------------------------------------------------------
    def train_round(self, client_flats: list, sp: torch.Tensor,
                    server_opt: dict, server_logits: torch.Tensor,
                    shards: dict):
        """One GKT round over every client: (client vectors, server vector,
        server optimizer state, server logits [C, B, bs, classes], client
        losses [C], server loss)."""
        C = shards["mask"].shape[0]
        feats = None                  # the uploads, [C, B, bs, ...] on the device
        new_flats, logits, losses = [], [], []
        for c in range(C):
            p, f, lg, loss = self._client_phase(
                client_flats[c], {k: v[c] for k, v in shards.items()},
                server_logits[c])
            if feats is None:
                feats = f.new_empty((C,) + tuple(f.shape))
            feats[c] = f
            new_flats.append(p)
            logits.append(lg)
            losses.append(loss)
        sp, server_opt, server_logits, s_loss = self._server_phase(
            sp, server_opt, feats, torch.stack(logits), shards["y"],
            shards["mask"])
        return new_flats, sp, server_opt, server_logits, torch.stack(losses), s_loss

    # -- the run loop ---------------------------------------------------------
    def run(self, rounds: Optional[int] = None, params=None):
        """Returns (every client's params, the server's params); `params`
        (client, server) overrides init_params()."""
        cfg = self.cfg
        cp0, sp0 = params if params is not None else self.init_params()
        C = self.data.client_num
        shards, _ = self.data.device_shards(self.device)
        flats = [self.client.flatten(cp0)] * C
        sp = self.server.flatten(sp0)
        server_opt = self.server_tx.init(sp)
        B, bs = shards["mask"].shape[1:3]
        server_logits = torch.zeros(C, B, bs, self.data.class_num,
                                    device=self.device)
        real = torch.as_tensor(self.data.client_num_samples > 0,
                               device=self.device)
        rounds = rounds if rounds is not None else cfg.comm_round
        for round_idx in range(rounds):
            t0 = time.time()
            flats, sp, server_opt, server_logits, losses, s_loss = \
                self.train_round(flats, sp, server_opt, server_logits, shards)
            if (round_idx % cfg.frequency_of_the_test == 0
                    or round_idx == rounds - 1):
                stats = self.evaluate(self.client.unflatten(flats[0]),
                                      self.server.unflatten(sp))
                # the mean over clients that have data
                stats.update(round=round_idx,
                             client_loss=float((losses * real).sum()
                                               / torch.clamp(real.sum(), min=1)),
                             server_loss=float(s_loss),
                             round_time=time.time() - t0)
                self.metrics_history.append(stats)
                log.info("gkt round %d: %s", round_idx, stats)
        return ([self.client.unflatten(f) for f in flats],
                self.server.unflatten(sp))

    @torch.no_grad()
    def evaluate(self, client_params: dict, server_params: dict) -> dict:
        shard = to_device(self.data.test_global, self.device)
        cp = self.client.flatten(client_params)
        sp = self.server.flatten(server_params)
        correct = count = 0.0
        for b in range(shard["mask"].shape[0]):
            f, _ = self.client(cp, shard["x"][b])
            c, n = masked_accuracy_sums(self.server(sp, f), shard["y"][b],
                                        shard["mask"][b])
            correct, count = correct + c, count + n
        return {"test_acc": float(correct) / max(float(count), 1.0)}


class MeshFedGKTEngine(FedGKTEngine):
    """FedGKT over a mesh of ranks (the module docstring); `mesh` defaults
    to this process alone, where every fold is the identity."""

    def __init__(self, client_model, server_model, data: FederatedData,
                 cfg: FedConfig, mesh=None, **kw):
        from fedml_tpu_torch.parallel.engine import MeshExchange
        from fedml_tpu_torch.parallel.mesh import pad_cohort
        from fedml_tpu_torch.parallel.multihost import make_local_mesh
        super().__init__(client_model, server_model, data, cfg, **kw)
        self.mesh = mesh if mesh is not None else make_local_mesh()
        self.axes = tuple(self.mesh.axis_names)
        self.n = self.mesh.size
        self.index = self.mesh.index(self.axes)
        self.exchange = MeshExchange(self.mesh)
        self._real_clients = data.client_num
        shards = {k: np.asarray(v) for k, v in data.client_shards.items()}
        w = np.asarray(data.client_num_samples, np.float32)
        # the stack padded with zero-mask clients (a no-op local phase and
        # frozen server steps), and each batch padded with mask-0 samples
        shards, w = pad_cohort(shards, w, self.n)
        pad_bs = (-shards["mask"].shape[2]) % self.n

        def pad2(a):
            width = [(0, 0)] * a.ndim
            width[2] = (0, pad_bs)
            return np.pad(a, width)

        self._host = {k: pad2(v) for k, v in shards.items()}
        self._weights = w
        C, bs = self._host["mask"].shape[0], self._host["mask"].shape[2]
        self._clients = slice(self.index * C // self.n,
                              (self.index + 1) * C // self.n)
        self._rows = slice(self.index * bs // self.n,
                           (self.index + 1) * bs // self.n)

    def _server_phase_split(self, sp: torch.Tensor, opt_state: dict,
                            f_s, c_s, y_s, m_s, m_full):
        """`server_epochs` over the K x B stream of this rank's batch rows
        (f_s, c_s, y_s, m_s [K*B, bs/n, ...]); `m_full` [K*B, bs] is every
        rank's mask, so c_g needs no exchange.  Returns (server vector,
        optimizer state, mean epoch loss)."""
        c_g = m_full.float().sum(dim=1)
        real = (c_g > 0).float()
        epoch_losses = []
        for _ in range(self.server_epochs):
            losses = []
            for i in range(f_s.shape[0]):
                c_l = m_s[i].float().sum()

                def loss_fn(q, i=i, c_l=c_l):
                    return self._server_loss(q, f_s[i], c_s[i], y_s[i],
                                             m_s[i]) * c_l / torch.clamp(
                        c_g[i], min=1.0)

                leaf = sp.detach().requires_grad_()
                loss = loss_fn(leaf)
                (grad,) = torch.autograd.grad(loss, leaf)
                host = torch.cat([grad.float(), loss.detach().float()
                                  .reshape(1)]).to("cpu").numpy()
                tot = torch.from_numpy(self.exchange.fold(
                    host, self.axes)).to(sp.device)
                grad, loss = tot[:-1].to(grad.dtype), tot[-1]
                updates, new_state = self.server_tx.update(grad, opt_state,
                                                           sp)
                has = real[i] > 0
                sp = torch.where(has, sp + updates, sp)
                opt_state = self.server_tx.select(has, new_state, opt_state)
                losses.append(loss)
            epoch_losses.append((torch.stack(losses) * real).sum()
                                / torch.clamp(real.sum(), min=1.0))
        return sp, opt_state, torch.stack(epoch_losses).mean()

    def _gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's `t` (one shape on every rank) concatenated along
        axis 0 in rank order, on t's device."""
        parts = self.exchange.gather(t.detach().to("cpu").numpy(), self.axes)
        return torch.from_numpy(np.concatenate(parts)).to(t.device)

    def train_round_mesh(self, flats: list, sp: torch.Tensor,
                         server_opt: dict, server_logits: torch.Tensor,
                         shards: dict, full_mask: torch.Tensor):
        """One round: this rank's clients (`shards`, server_logits [Cr, B,
        bs, classes]), then the batch-split server phase over every
        client; returns (client vectors, server vector, optimizer state,
        this rank's clients' server logits, every client's loss, server
        loss)."""
        Cr = shards["mask"].shape[0]
        new_flats, feats, logits, losses = [], [], [], []
        for c in range(Cr):
            p, f, lg, loss = self._client_phase(
                flats[c], {k: v[c] for k, v in shards.items()},
                server_logits[c])
            new_flats.append(p)
            feats.append(f)
            logits.append(lg)
            losses.append(loss)
        # the upload: every client's features and logits on every rank
        feats = self._gather(torch.stack(feats))        # [C, B, bs, ...]
        logits = self._gather(torch.stack(logits))
        losses = self._gather(torch.stack(losses))
        C, B = feats.shape[:2]
        fl = lambda a: a.reshape((C * B,) + a.shape[2:])
        ys = torch.as_tensor(self._host["y"]).to(self.device)
        sp, server_opt, s_loss = self._server_phase_split(
            sp, server_opt, fl(feats[:, :, self._rows]),
            fl(logits[:, :, self._rows]), fl(ys[:, :, self._rows]),
            fl(full_mask[:, :, self._rows]), fl(full_mask))
        with torch.no_grad():      # the download: this rank's clients
            mine = feats[self._clients]
            slog = torch.stack([torch.stack([self.server(sp, mine[c, b])
                                             for b in range(B)])
                                for c in range(Cr)])
        return new_flats, sp, server_opt, slog, losses, s_loss

    def run(self, rounds: Optional[int] = None, params=None):
        """Returns (every real client's params, the server's params), the
        same on every rank; the mesh's first rank evaluates."""
        cfg = self.cfg
        cp0, sp0 = params if params is not None else self.init_params()
        mine = to_device({k: v[self._clients] for k, v in self._host.items()},
                         self.device)
        full_mask = torch.as_tensor(self._host["mask"]).to(self.device)
        Cr, B, bs = mine["mask"].shape[:3]
        flats = [self.client.flatten(cp0)] * Cr
        sp = self.server.flatten(sp0)
        server_opt = self.server_tx.init(sp)
        server_logits = torch.zeros(Cr, B, bs, self.data.class_num,
                                    device=self.device)
        real = torch.as_tensor(self._weights > 0, device=self.device)
        rounds = rounds if rounds is not None else cfg.comm_round
        for round_idx in range(rounds):
            t0 = time.time()
            flats, sp, server_opt, server_logits, losses, s_loss = \
                self.train_round_mesh(flats, sp, server_opt, server_logits,
                                      mine, full_mask)
            if self.mesh.is_first and (
                    round_idx % cfg.frequency_of_the_test == 0
                    or round_idx == rounds - 1):
                stats = self.evaluate(self.client.unflatten(flats[0]),
                                      self.server.unflatten(sp))
                stats.update(round=round_idx,
                             client_loss=float(
                                 (losses * real).sum()
                                 / torch.clamp(real.sum(), min=1)),
                             server_loss=float(s_loss),
                             round_time=time.time() - t0)
                self.metrics_history.append(stats)
                log.info("gkt round %d: %s", round_idx, stats)
        every = self._gather(torch.stack(flats))[:self._real_clients]
        return ([self.client.unflatten(f) for f in every],
                self.server.unflatten(sp))
