"""Synthetic federated datasets (port of fedml_tpu/data/synthetic.py;
host-side numpy, bitwise equal to the JAX package's).

Two roles:
1. The FedProx-paper synthetic(alpha, beta) generator — a real benchmark
   config of the reference (benchmark/README.md:14; reference ships only the
   pre-generated JSONs under fedml_api/data_preprocessing/synthetic_*).
   Implemented from the published process: per-client model W_k,b_k ~
   N(u_k, 1), u_k ~ N(0, alpha); inputs x ~ N(v_k, Sigma),
   v_k ~ N(B_k, 1), B_k ~ N(0, beta); labels y = argmax(W x + b).
2. Deterministic stand-ins for datasets whose files are not on disk (this
   image has zero network egress) — same shapes, dtypes, vocab sizes and
   client counts as the real thing, so every pipeline runs end-to-end and
   perf numbers are valid; accuracy numbers then measure the synthetic task.
"""
from __future__ import annotations

import numpy as np


def synthetic_fedprox(alpha: float, beta: float, n_clients: int = 30,
                      dim: int = 60, n_classes: int = 10, seed: int = 0):
    """Returns (x [N, dim] f32, y [N] i64, net_dataidx_map)."""
    rng = np.random.RandomState(seed)
    # power-law client sizes, as in the FedProx paper (lognormal sizes)
    sizes = (rng.lognormal(4, 2, n_clients).astype(int) + 50)
    diag = np.array([(j + 1) ** -1.2 for j in range(dim)])
    xs, ys, idx_map, off = [], [], {}, 0
    for k in range(n_clients):
        u_k = rng.normal(0, alpha)
        B_k = rng.normal(0, beta)
        W = rng.normal(u_k, 1, (dim, n_classes))
        b = rng.normal(u_k, 1, n_classes)
        v_k = rng.normal(B_k, 1, dim)
        x = rng.multivariate_normal(v_k, np.diag(diag), sizes[k]).astype(np.float32)
        y = np.argmax(x @ W + b, axis=1).astype(np.int64)
        xs.append(x); ys.append(y)
        idx_map[k] = np.arange(off, off + sizes[k])
        off += sizes[k]
    return np.concatenate(xs), np.concatenate(ys), idx_map


def synthetic_classification_images(n: int, hw: tuple[int, int], channels: int,
                                    n_classes: int, seed: int = 0,
                                    flat: bool = False):
    """Learnable synthetic image task: class templates + noise, so accuracy
    oracles (federated == centralized) remain meaningful without real data."""
    rng = np.random.RandomState(seed)
    h, w = hw
    shape = (h * w * channels,) if flat else (h, w, channels)
    templates = rng.normal(0, 1, (n_classes,) + shape).astype(np.float32)
    y = rng.randint(0, n_classes, n).astype(np.int64)
    x = templates[y] * 0.5 + rng.normal(0, 1, (n,) + shape).astype(np.float32)
    return x.astype(np.float32), y


def synthetic_segmentation(n: int, hw: tuple[int, int], n_classes: int,
                           seed: int = 0, void_frac: float = 0.02,
                           void_id: int = 255):
    """Learnable synthetic segmentation task (pascal_voc stand-in): each
    pixel's class is a deterministic function of local color thresholds,
    with a sprinkle of void (ignore-index 255) pixels like real VOC
    boundary bands."""
    rng = np.random.RandomState(seed)
    h, w = hw
    x = rng.rand(n, h, w, 3).astype(np.float32)
    # class = number of channels above 0.5, capped — smooth, learnable
    y = np.minimum((x > 0.5).sum(axis=-1), n_classes - 1).astype(np.int64)
    void = rng.rand(n, h, w) < void_frac
    y[void] = void_id
    return x, y


def synthetic_sequences(n: int, seq_len: int, vocab: int, seed: int = 0):
    """Markov-chain token sequences for LM tasks (shakespeare/stackoverflow
    stand-in): x = seq[:-1], y = seq[1:].

    Sampling inverts each row's CDF with searchsorted, GROUPED BY CURRENT
    TOKEN: the historical formulation gathered a full [rows, vocab]
    float64 cum matrix per step — ~1 TB of memory traffic (and 985 s) at
    the reference's 342k-client stackoverflow scale (684,954 rows ×
    10,004 vocab) — while grouping touches each state's cum row once per
    step and binary-searches the group's uniforms against it.  The rng
    stream and the math are unchanged ((r > cum).sum() == searchsorted
    (cum, r, 'left') for sorted cum), so the output is BIT-IDENTICAL to
    the historical version (pinned by tests/test_data_extended.py)."""
    rng = np.random.RandomState(seed)
    # sparse transition matrix => learnable structure (at small vocab;
    # see synthetic_sequences_classed for why this reverts to noise at
    # large vocab)
    trans = rng.dirichlet(np.full(vocab, 0.05), size=vocab)
    cumt = np.cumsum(trans, axis=1)       # precompute rows once
    del trans
    # identity state->row mapping: each token owns its transition row
    seqs = _sample_grouped_markov(rng, n, seq_len, vocab,
                                  np.arange(vocab), cumt)
    return seqs[:, :-1].astype(np.int32), seqs[:, 1:].astype(np.int64)


def _sample_grouped_markov(rng, n: int, seq_len: int, vocab: int,
                           key_of_state: np.ndarray,
                           cum_rows: np.ndarray) -> np.ndarray:
    """Shared Markov sampler: grouped inverse-CDF over `cum_rows`,
    where state s uses row `key_of_state[s]`.  Grouping touches each
    row once per step and binary-searches the group's uniforms against
    it; the rng stream and math match the historical per-row gather
    formulation bit-exactly ((r > cum).sum() == searchsorted(cum, r,
    'left') for sorted cum — pinned by tests/test_data_extended.py)."""
    seqs = np.zeros((n, seq_len + 1), np.int32)
    seqs[:, 0] = rng.randint(0, vocab, n)
    for t in range(seq_len):
        r = rng.rand(n)                   # same stream as the row loop
        keys = key_of_state[seqs[:, t]]
        order = np.argsort(keys, kind="stable")
        uniq, starts = np.unique(keys[order], return_index=True)
        ends = np.append(starts[1:], n)
        nxt = np.empty(n, np.int64)
        for i, k in enumerate(uniq):
            sel = order[starts[i]:ends[i]]
            nxt[sel] = np.searchsorted(cum_rows[k], r[sel], side="left")
        seqs[:, t + 1] = np.clip(nxt, 0, vocab - 1)
    return seqs


def synthetic_sequences_classed(n: int, seq_len: int, vocab: int,
                                n_classes: int = 64, seed: int = 0,
                                row_alpha_total: float = 10.0):
    """Low-rank learnable Markov sequences for LARGE-vocab LM tasks.

    `synthetic_sequences` draws every state's transition row i.i.d.
    Dirichlet — a full-rank random [V, V] matrix.  At vocab 404 a
    d=96 embedding model captures a usable fraction of it (rank/V ~
    1/4, the CPU smoke learns); at the stackoverflow vocab of 10,004
    the same model is rank-limited to ~1% of the structure and every
    curve flat-lines at ln(V) — as
    expected: random matrices are not low-rank, but natural language
    (the real task) is.  This variant makes the stand-in learnable at
    any vocab by construction: tokens are randomly assigned to
    `n_classes` classes and the transition row depends only on the
    CURRENT TOKEN'S CLASS — a rank-`n_classes` chain, exactly
    representable by any model whose embedding width >= n_classes
    (infer the class from the token, emit the class's row).

    Row sharpness must be vocab-INVARIANT or large vocabs silently
    revert to noise: a fixed per-coordinate Dirichlet alpha makes the
    effective concentration alpha*V grow with vocab (alpha=0.05 at
    V=10,004 spreads each row over ~500 tokens — oracle_top1 measured
    0.0102, so even a perfect model sits at 1%).  `row_alpha_total` is
    the TOTAL concentration: per-coordinate alpha = row_alpha_total /
    vocab, so every class's next-token distribution concentrates on
    ~row_alpha_total tokens at any vocab (default 10 -> oracle ~0.2,
    measured 0.205/0.194/0.192 at V=404/2004/10004).

    Same grouped inverse-CDF sampling as synthetic_sequences; x =
    seq[:-1], y = seq[1:].  Returns (x, y, oracle_top1): oracle_top1
    is the Bayes accuracy (mean max-prob of the class rows under the
    chain's empirical state distribution) — the ceiling a perfect
    model would hit, recorded in convergence artifacts for context."""
    rng = np.random.RandomState(seed)
    cls = rng.randint(0, n_classes, vocab)
    rows = rng.dirichlet(np.full(vocab, row_alpha_total / vocab),
                         size=n_classes)
    seqs = _sample_grouped_markov(rng, n, seq_len, vocab, cls,
                                  np.cumsum(rows, axis=1))
    # Bayes ceiling: P(correct) when always predicting the current
    # class-row's argmax, weighted by how often each class is the state
    state_cls = cls[seqs[:, :-1]]
    freq = np.bincount(state_cls.ravel(), minlength=n_classes)
    oracle_top1 = float((rows.max(axis=1) * freq).sum() / freq.sum())
    return seqs[:, :-1].astype(np.int32), seqs[:, 1:].astype(np.int64), \
        oracle_top1


def synthetic_multilabel(n: int, dim: int, n_tags: int, seed: int = 0):
    """Bag-of-words -> tag multi-label task (stackoverflow_lr stand-in)."""
    rng = np.random.RandomState(seed)
    proj = rng.normal(0, 1, (dim, n_tags)).astype(np.float32)
    x = (rng.rand(n, dim) < 0.05).astype(np.float32)
    logits = x @ proj
    y = (logits > np.percentile(logits, 90, axis=1, keepdims=True)).astype(np.float32)
    return x, y


def synthetic_tabular(n: int, dim: int, seed: int = 0, n_classes: int = 2):
    """Gaussian-blob tabular task (UCI SUSY / room-occupancy / lending-club
    stand-in): linearly separable with noise, so accuracy climbs."""
    rng = np.random.RandomState(seed)
    w = rng.normal(0, 1, (dim, n_classes)).astype(np.float32)
    x = rng.normal(0, 1, (n, dim)).astype(np.float32)
    y = np.argmax(x @ w + rng.normal(0, 0.5, (n, n_classes)), axis=1)
    return x, y.astype(np.int64)
