"""FedAvg (port of fedml_tpu/algorithms/fedavg.py::FedAvgEngine).

One round: every sampled client runs local SGD from the global model, then
the server installs the sample-weighted mean of the trained models.  The
mean goes through the fold kernel's finalize form (``ops.weighted_mean``)
on the card.  The JAX engine vmaps the cohort into one XLA program; here
the clients run one after another on the engine's device.

Parity targets: fedml_api/standalone/fedavg/fedavg_api.py:40-115 (loop,
_aggregate), fedml_api/distributed/fedavg/FedAVGAggregator.py:59-98.
"""
from __future__ import annotations

import logging
import time
from typing import Optional

import torch

from fedml_tpu_torch import obs
from fedml_tpu_torch.obs import programs as obs_programs
from fedml_tpu_torch.core.sampling import ClientSampler
from fedml_tpu_torch.core.trainer import ClientTrainer, client_generator
from fedml_tpu_torch.data.federated import FederatedData
from fedml_tpu_torch.ops.aggregate import weighted_mean
from fedml_tpu_torch.utils.config import FedConfig
from fedml_tpu_torch.utils.device import resolve_device, to_device

log = logging.getLogger(__name__)


def stack_rows(trainer: ClientTrainer, rows: list) -> dict:
    """K trained flat vectors -> {name: [K, ...]} leaves of one [K, P] stack."""
    spec = trainer.spec
    parts = torch.split(torch.stack(rows)[:, :spec.n], spec.sizes, dim=1)
    return {name: part.reshape((-1,) + shape)
            for name, shape, part in zip(spec.names, spec.shapes, parts)}


class FedAvgEngine:
    """Standalone-simulation FedAvg on one device (CUDA unless `device`
    names another).

    `round_fn` dispatches through the obs/programs.py profile registry
    under `program_family`, the JAX package's name for the round (each
    subclass names its own): per-family dispatch counts, host walls and
    the card's stream time, values untouched."""

    program_family = "fedavg_resident"

    def __init__(self, trainer: ClientTrainer, data: FederatedData,
                 cfg: FedConfig, device=None):
        self.round_fn = obs_programs.instrument(self.program_family,
                                                self.round_fn)
        self.device = resolve_device(device)
        self.trainer = trainer
        self.data = data
        self.cfg = cfg
        self.sampler = ClientSampler.for_data(data, cfg)
        self._eval_shards = {"train": to_device(data.train_global, self.device),
                             "test": to_device(data.test_global, self.device)}
        self._local_eval_shards: dict = {}
        self.metrics_history: list[dict] = []

    # ---- server state ------------------------------------------------------
    def server_init(self, variables: dict):
        return ()

    def server_update(self, avg_variables: dict, global_variables: dict,
                      server_state):
        """FedAvg installs the average directly (FedAVGAggregator.py:59-88)."""
        return avg_variables, server_state

    # ---- aggregation --------------------------------------------------------
    def aggregate(self, stacked_variables: dict, weights: torch.Tensor,
                  global_variables: dict, server_state):
        """Sample-weighted mean over ALL variables, parameters and BatchNorm
        statistics alike, as the reference iterates over every state_dict
        key (FedAVGAggregator.py:74-81)."""
        return weighted_mean(stacked_variables, weights), server_state

    # ---- one federated round ------------------------------------------------
    def _train_cohort(self, flat: torch.Tensor, cohort: dict,
                      round_idx: int = 0):
        """Every client's local training from the global flat vector, each
        with its own dropout generator: (trained rows, losses [K], sample
        counts [K])."""
        global_params = flat if self.trainer.prox_mu > 0 else None
        rows, losses, ns = [], [], []
        for i in range(cohort["mask"].shape[0]):
            v, loss, n = self.trainer.local_train(
                flat, {k: t[i] for k, t in cohort.items()}, self.cfg.epochs,
                global_params=global_params,
                generator=client_generator(self.cfg.seed, round_idx, i,
                                           self.device))
            rows.append(v)
            losses.append(loss)
            ns.append(n)
        return rows, torch.stack(losses), torch.stack(ns)

    def _round(self, variables: dict, server_state, cohort: dict,
               round_idx: int = 0):
        rows, losses, ns = self._train_cohort(self.trainer.flatten(variables),
                                              cohort, round_idx)
        new_variables, server_state = self.aggregate(
            stack_rows(self.trainer, rows), ns, variables, server_state)
        train_loss = (losses * ns).sum() / ns.sum()
        return new_variables, server_state, {"train_loss": train_loss}

    round_fn = _round

    # ---- run loop -----------------------------------------------------------
    def init_variables(self, generator: Optional[torch.Generator] = None) -> dict:
        if generator is None:
            generator = torch.Generator().manual_seed(self.cfg.seed)
        return self.trainer.init(generator, self.device)

    def _round_args(self, round_idx: int) -> tuple:
        cohort, _ = self.data.cohort(self.sampler.sample(round_idx), self.device)
        return cohort, round_idx

    def run(self, variables: Optional[dict] = None,
            rounds: Optional[int] = None) -> dict:
        """The reference's train() loop (fedavg_api.py:40-81)."""
        cfg = self.cfg
        variables = variables if variables is not None else self.init_variables()
        server_state = self.server_init(variables)
        rounds = rounds if rounds is not None else cfg.comm_round
        # observability (fedml_tpu_torch/obs; no-ops until configured):
        # a span per round and per evaluation, an optional deadline
        # watchdog (a flight dump when a round overruns
        # cfg.round_deadline_s), and a dump before an error propagates
        engine_name = type(self).__name__
        try:
            for round_idx in range(rounds):
                t0 = time.time()
                with obs.deadline(f"round{round_idx}", cfg.round_deadline_s), \
                        obs.span("round", round=round_idx, engine=engine_name):
                    variables, server_state, m = self.round_fn(
                        variables, server_state, *self._round_args(round_idx))
                if (round_idx % cfg.frequency_of_the_test == 0
                        or round_idx == rounds - 1):
                    with obs.span("eval", round=round_idx):
                        stats = self.evaluate(variables)
                    stats.update(round=round_idx,
                                 train_loss=float(m["train_loss"]),
                                 round_time=time.time() - t0)
                    self.metrics_history.append(stats)
                    log.info("round %d: %s", round_idx, stats)
                    if obs.enabled():       # live and peak device memory
                        obs.sample_device_memory()
        except Exception as e:
            obs.dump_flight(f"engine_error:{engine_name}: {e!r}")
            raise
        return variables

    # ---- evaluation ---------------------------------------------------------
    def evaluate(self, variables: dict) -> dict:
        """Server-side eval on the global train/test shards
        (FedAVGAggregator.test_on_server_for_all_clients, :110-164)."""
        flat = self.trainer.flatten(variables)
        out = {}
        for split, shard in self._eval_shards.items():
            sums = self.trainer.evaluate(flat, shard)
            cnt = float(sums["count"])
            out[f"{split}_acc"] = float(sums["correct"]) / max(cnt, 1.0)
            out[f"{split}_loss"] = float(sums["loss_sum"]) / max(cnt, 1.0)
        if self.cfg.local_test_eval and self.data.test_client_shards is not None:
            out.update(self.evaluate_local(variables))
        return out

    def _local_train_stack(self) -> dict:
        """The host client stack evaluate_local(split="train") uploads (the
        mesh engines: their uint8 or cast view)."""
        return self.data.client_shards

    def _local_eval_transform(self, shard: dict) -> dict:
        """Per-client shard hook of evaluate_local (the mesh engines
        dequantize a uint8 shard here; identity for this engine)."""
        return shard

    def evaluate_local(self, variables: dict, split: str = "test") -> dict:
        """Eval on every client's OWN shard (the reference's
        _local_test_on_all_clients, fedavg_api.py:117-213), summed over
        clients into one weighted accuracy.  With cfg.ci only the first
        client is evaluated (the reference's --ci 1 mode)."""
        if split not in ("train", "test"):
            raise ValueError(f"split must be 'train' or 'test', got {split!r}")
        if split == "test" and self.data.test_client_shards is None:
            raise ValueError("this dataset has no per-client test shards")
        if split not in self._local_eval_shards:
            shards = (self.data.test_client_shards if split == "test"
                      else self._local_train_stack())
            if self.cfg.ci:
                shards = {k: v[:1] for k, v in shards.items()}
            self._local_eval_shards[split] = to_device(shards, self.device)
        stack = self._local_eval_shards[split]
        flat = self.trainer.flatten(variables)
        sums = None
        for c in range(stack["mask"].shape[0]):
            m = self.trainer.evaluate(flat, self._local_eval_transform(
                {k: v[c] for k, v in stack.items()}))
            sums = m if sums is None else {k: sums[k] + m[k] for k in m}
        cnt = float(sums["count"])
        return {f"local_{split}_acc": float(sums["correct"]) / max(cnt, 1.0),
                f"local_{split}_loss": float(sums["loss_sum"]) / max(cnt, 1.0)}
