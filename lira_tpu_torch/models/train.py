"""Training / evaluation / inference loops for the probing MLP (port of
lira_tpu/models/train.py).

The state is a `ProbingMLP` and `torch.optim.Adam(lr=1e-4, eps=1e-8)`:
optax's `adam` and torch's Adam take the same step, the bias-corrected
m̂ / (√v̂ + eps).  The loss is the per-row mean of BCE from logits,
averaged over the real rows of each batch.  An epoch walks the rows in
order (no shuffle) through lira_tpu's superbatch windows, the ragged tail
zero-padded and masked out of the loss.  Features already on the card are
sliced there; host arrays are uploaded one superbatch at a time.  The loss
is summed on the device and read once per superbatch.

`train_state_from_jax` / `train_state_to_jax` carry parameters and Adam
moments across from / to lira_tpu's optax state.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device, true_fp32
from .probing_mlp import _LAYERS, ProbingMLP, params_from_jax, params_to_jax


@dataclass
class TrainState:
    model: ProbingMLP
    opt: torch.optim.Adam

    @property
    def params(self) -> ProbingMLP:
        """The model: what QueryEngine and the loops below take as params."""
        return self.model

    @property
    def device(self) -> torch.device:
        return self.model.head2.weight.device


def _adam(model: ProbingMLP, lr: float) -> torch.optim.Adam:
    return torch.optim.Adam(model.parameters(), lr=lr, eps=1e-8)


def make_train_state(seed: int, n_bkt: int, dim: int, lr: float = 1e-4,
                     device=None) -> TrainState:
    """A ProbingMLP initialised from a torch generator seeded with `seed`
    (torch.nn.Linear's rule; not jax.random's numbers), and its Adam."""
    dev = resolve_device(device)
    model = ProbingMLP(n_bkt, dim, generator=torch.Generator().manual_seed(seed)).to(dev)
    return TrainState(model=model, opt=_adam(model, lr))


def _param_pairs(model: ProbingMLP):
    """(layer, leaf, parameter) in lira_tpu's tree order."""
    for name in _LAYERS:
        lin = getattr(model, name)
        yield name, "w", lin.weight
        yield name, "b", lin.bias


def _to_torch_layout(leaf: str, arr) -> torch.Tensor:
    a = np.asarray(arr, np.float32)
    return torch.from_numpy((a.T if leaf == "w" else a).copy())


def _to_jax_layout(leaf: str, t: torch.Tensor) -> np.ndarray:
    a = t.detach().cpu().numpy()
    return (a.T if leaf == "w" else a).copy()


def _adam_moments(opt_state):
    """(count, mu, nu) of an optax ScaleByAdamState, found in optax's
    chain tuple or given alone (attributes or a dict)."""
    states = opt_state if isinstance(opt_state, (tuple, list)) else (opt_state,)
    for st in states:
        if isinstance(st, dict) and "mu" in st:
            return st["count"], st["mu"], st["nu"]
        if hasattr(st, "mu") and hasattr(st, "nu"):
            return st.count, st.mu, st.nu
    raise ValueError("no ScaleByAdamState (count, mu, nu) in the given optimizer state")


def train_state_from_jax(params, opt_state, lr: float = 1e-4, device=None) -> TrainState:
    """TrainState from lira_tpu's parameter tree and optax Adam state (numpy
    or jax arrays): weights transposed as in `params_from_jax`, optax's
    mu/nu → torch's exp_avg/exp_avg_sq, count → step."""
    dev = resolve_device(device)
    model = params_from_jax(params).to(dev)
    opt = _adam(model, lr)
    count, mu, nu = _adam_moments(opt_state)
    step = int(np.asarray(count))
    if step > 0:
        for name, leaf, p in _param_pairs(model):
            opt.state[p] = {
                "step": torch.tensor(float(step)),
                "exp_avg": _to_torch_layout(leaf, mu[name][leaf]).to(dev),
                "exp_avg_sq": _to_torch_layout(leaf, nu[name][leaf]).to(dev),
            }
    return TrainState(model=model, opt=opt)


def train_state_to_jax(state: TrainState) -> tuple[dict, dict]:
    """(params, {"count", "mu", "nu"}) as numpy arrays in lira_tpu's tree
    layout; build optax's ScaleByAdamState(count, mu, nu) from the second."""
    params = params_to_jax(state.model)
    mu, nu, count = {}, {}, 0
    for name, leaf, p in _param_pairs(state.model):
        st = state.opt.state.get(p)
        if st:
            count = int(st["step"])
            m, v = _to_jax_layout(leaf, st["exp_avg"]), _to_jax_layout(leaf, st["exp_avg_sq"])
        else:
            m = v = np.zeros_like(params[name][leaf])
        mu.setdefault(name, {})[leaf] = m
        nu.setdefault(name, {})[leaf] = v
    return params, {"count": np.asarray(count, np.int32), "mu": mu, "nu": nu}


def _masked_bce_from_logits(logits, targets, row_mask):
    """Mean BCE over real rows (padding rows excluded from the mean)."""
    per_row = F.binary_cross_entropy_with_logits(logits, targets, reduction="none").mean(dim=-1)
    return (per_row * row_mask).sum() / torch.clamp_min(row_mask.sum(), 1.0)


def _superbatches(n: int, batch_size: int, super_rows: int):
    """Yield (start, end, padded_len) windows; padded_len is a batch multiple."""
    super_rows = max(batch_size, (super_rows // batch_size) * batch_size)
    for s in range(0, n, super_rows):
        e = min(s + super_rows, n)
        padded = ((e - s + batch_size - 1) // batch_size) * batch_size
        yield s, e, padded


def _rows_f32(x, s: int, e: int, padded: int, dev: torch.device) -> torch.Tensor:
    """Rows [s, e) of a host array or tensor as f32 on `dev`, zero-padded
    to `padded` rows."""
    if isinstance(x, torch.Tensor):
        blk = x[s:e].to(device=dev, dtype=torch.float32)
    else:
        blk = torch.as_tensor(np.asarray(x[s:e], np.float32), device=dev)
    if padded != e - s:
        blk = F.pad(blk, (0, 0, 0, padded - (e - s)))
    return blk


def train_epoch(
    state: TrainState,
    dist,
    vec,
    targets,
    batch_size: int = 64,
    super_rows: int = 262144,
) -> tuple[TrainState, float]:
    """One pass over the data (no shuffling, like the reference loader).

    Returns (state, mean per-batch loss); the state is updated in place."""
    model, opt, dev = state.model, state.opt, state.device
    model.train()
    n = len(dist)
    loss_sum, n_batches = 0.0, 0
    with true_fp32():
        for s, e, padded in _superbatches(n, batch_size, super_rows):
            bd = _rows_f32(dist, s, e, padded, dev)
            bv = _rows_f32(vec, s, e, padded, dev)
            bt = _rows_f32(targets, s, e, padded, dev)
            mask = torch.zeros(padded, dtype=torch.float32, device=dev)
            mask[: e - s] = 1.0
            ls = torch.zeros((), dtype=torch.float32, device=dev)
            for b in range(0, padded, batch_size):
                sl = slice(b, b + batch_size)
                loss = _masked_bce_from_logits(model.forward_logits(bd[sl], bv[sl]),
                                               bt[sl], mask[sl])
                opt.zero_grad(set_to_none=True)
                loss.backward()
                opt.step()
                ls += loss.detach()
            loss_sum += float(ls)  # one device read per superbatch
            n_batches += padded // batch_size
    model.eval()
    return state, loss_sum / max(n_batches, 1)


def _model(state_or_params) -> ProbingMLP:
    return getattr(state_or_params, "params", state_or_params)


@torch.no_grad()
def _batched_forward(model: ProbingMLP, dist, vec, chunk: int = 65536,
                     want_logits: bool = True):
    """Chunked forward; (probs, logits or None) as host arrays."""
    dev = model.head2.weight.device
    n = len(dist)
    outs, logits_all = [], []
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        logits = model.forward_logits(_rows_f32(dist, s, e, e - s, dev),
                                      _rows_f32(vec, s, e, e - s, dev))
        outs.append(torch.sigmoid(logits).cpu().numpy())
        if want_logits:
            logits_all.append(logits.cpu().numpy())
    return np.concatenate(outs), (np.concatenate(logits_all) if want_logits else None)


def evaluate(
    state_or_params,
    dist,
    vec,
    targets: np.ndarray,
    sigma: float = 0.5,
    batch_size: int = 64,
) -> tuple[np.ndarray, np.ndarray, float, np.ndarray]:
    """Returns (targets, predicts, avg_loss, outputs); avg_loss is the mean of
    per-batch mean BCE under the reference's batch partition, taken on the
    host from the logits as lira_tpu takes it."""
    outputs, logits = _batched_forward(_model(state_or_params), dist, vec)
    predicts = outputs > sigma

    t = np.asarray(targets, dtype=np.float32)
    per_elem = np.maximum(logits, 0) - logits * t + np.log1p(np.exp(-np.abs(logits)))
    per_row = per_elem.mean(axis=1)
    n = len(per_row)
    batch_means = [per_row[s : min(s + batch_size, n)].mean() for s in range(0, n, batch_size)]
    avg_loss = float(np.mean(batch_means))
    return t, predicts, avg_loss, outputs


@torch.no_grad()
def predict_counts(state_or_params, dist, vec, sigma: float = 0.5,
                   chunk: int = 65536) -> np.ndarray:
    """Per-row predicted-nprobe counts Σ(score > σ), reduced on the device:
    only (n,) int32 leaves it.  Identical to `infer(...)[0].sum(axis=1)`."""
    model = _model(state_or_params)
    dev = model.head2.weight.device
    out = np.empty(len(dist), np.int32)
    for s in range(0, len(dist), chunk):
        e = min(s + chunk, len(dist))
        probs = model(_rows_f32(dist, s, e, e - s, dev), _rows_f32(vec, s, e, e - s, dev))
        out[s:e] = (probs > sigma).sum(dim=1).to(torch.int32).cpu().numpy()
    return out


def infer(state_or_params, dist, vec, sigma: float = 0.5) -> tuple[np.ndarray, np.ndarray]:
    """(predicts, outputs) — the redundancy engine's scoring pass; skips
    the logits transfer."""
    outputs, _ = _batched_forward(_model(state_or_params), dist, vec, want_logits=False)
    return outputs > sigma, outputs
