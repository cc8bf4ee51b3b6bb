"""Contextual bandits with action-dependent features (ADF), on the device.

Counterpart of ``mmlspark_tpu/models/vw/bandit.py``: a re-design of the
reference's VW contextual bandit integration (reference:
vw/VowpalWabbitContextualBandit.scala:28-359 — ``--cb_explore_adf`` multiline
examples, exploration policies, IPS/SNIPS counterfactual metrics, parallel
multi-config fit; vw/VectorZipper.scala — action assembly;
vw/VowpalWabbitInteractions.scala — FNV-1 namespace interactions).

Each row is a fixed-shape (padded) tensor of K action vectors plus one shared
vector. The JAX package scans the examples in one compiled program; here
the examples stay on the device and each is one step
(:func:`_example_step`; on CUDA captured once as a graph and replayed per
example, :class:`_EventGraph`) that

- scores every action with each ensemble member's linear model (shared
  block + ADF action block + the shared x action interaction block),
- forms the exploration distribution of the current ensemble,
- folds the IPS/SNIPS counters into a device-resident vector, and
- applies the MTR update on the logged action (squared loss on the
  observed cost, importance 1/logged_probability, AdaGrad), to all
  ensemble members at once: their updates are independent, so this is
  the JAX package's unrolled per-member loop.

Products are broadcast multiplies and sums (no cuBLAS call), so two fits of
the same data give the same bits on the card whatever runs beside them.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ...core.dataset import Dataset
from ...core.params import (HasFeaturesCol, HasInputCols, HasLabelCol,
                            HasOutputCol, HasPredictionCol, Param,
                            TypeConverters)
from ...core.pipeline import Estimator, Model, Transformer
from ...device import resolve_device
from .api import _to_device
from .sgd import capture_graph


class ContextualBanditMetrics:
    """IPS / SNIPS counterfactual estimators (reference:
    VowpalWabbitContextualBandit.scala:55-84, after
    VowpalWabbit/estimators ips_snips.py)."""

    def __init__(self, snips_numerator: float = 0.0, total_events: float = 0.0,
                 snips_denominator: float = 0.0,
                 offline_policy_events: float = 0.0,
                 max_ips_numerator: float = 0.0):
        self.snips_numerator = snips_numerator
        self.total_events = total_events
        self.snips_denominator = snips_denominator
        self.offline_policy_events = offline_policy_events
        self.max_ips_numerator = max_ips_numerator

    def add_example(self, prob_logging_policy: float, reward: float,
                    prob_eval_policy: float, count: int = 1) -> None:
        self.total_events += count
        if prob_eval_policy > 0:
            p_over_p = prob_eval_policy / prob_logging_policy
            self.snips_denominator += p_over_p * count
            self.offline_policy_events += count
            if reward != 0:
                self.snips_numerator += reward * p_over_p * count
                self.max_ips_numerator = max(self.max_ips_numerator,
                                             reward * p_over_p)

    def get_snips_estimate(self) -> float:
        return self.snips_numerator / self.snips_denominator

    def get_ips_estimate(self) -> float:
        return self.snips_numerator / self.total_events


def _stack_actions(col) -> Tuple[np.ndarray, np.ndarray]:
    """Ragged per-row action lists -> ([n, K_max, d] padded, [n, K_max] mask).

    Rows with zero actions are legal at scoring time (mask all-zero, empty
    probability list downstream); the action dimensionality comes from the
    first non-empty row.
    """
    n = len(col)
    ks = [len(row) for row in col]
    k_max = max(ks) if ks else 1
    k_max = max(k_max, 1)
    d = 1
    for row in col:
        if len(row):
            d = len(np.asarray(row[0]).ravel())
            break
    out = np.zeros((n, k_max, d), dtype=np.float32)
    mask = np.zeros((n, k_max), dtype=np.float32)
    for i, row in enumerate(col):
        for k, vec in enumerate(row):
            out[i, k] = np.asarray(vec, dtype=np.float32).ravel()
            mask[i, k] = 1.0
    return out, mask


# The policies take one example's ``[K]`` scores and mask or a batch's
# ``[..., K]``; every reduction is over the last axis.


def _one_hot(best: torch.Tensor, K: int) -> torch.Tensor:
    return (torch.arange(K, device=best.device) == best[..., None]).to(
        torch.float32)


def _epsilon_greedy(scores, mask, epsilon):
    """Exploration distribution over valid actions: lowest predicted cost gets
    1 - eps + eps/K, the rest eps/K each (VW --cb_explore_adf epsilon)."""
    # max(k_valid, 1): a zero-action row divides by 1 and, with an all-zero
    # mask, still yields all-zero probabilities instead of NaN
    k_valid = torch.clamp(mask.sum(dim=-1, keepdim=True), min=1.0)
    masked = torch.where(mask > 0, scores, torch.inf)
    best = torch.argmin(masked, dim=-1)
    base = (epsilon / k_valid) * mask
    return base + (1.0 - epsilon) * (_one_hot(best, mask.shape[-1]) * mask)


def _softmax_policy(scores, mask, lam):
    """VW --softmax: p(a) proportional to exp(-lambda * cost_score(a)) over the
    valid actions (scores predict COST, so lower score -> higher probability;
    lambda -> inf recovers greedy, 0 uniform)."""
    z = torch.where(mask > 0, -lam * scores, -torch.inf)
    z = z - torch.max(torch.where(mask > 0, z, -torch.inf), dim=-1,
                      keepdim=True).values
    e = torch.where(mask > 0, torch.exp(z), 0.0)
    denom = torch.clamp(e.sum(dim=-1, keepdim=True), min=1e-38)
    return e / denom


def _greedy_policy(scores, mask):
    """Pure exploit: probability 1 on the lowest-cost valid action (the
    post-tau regime of VW --first)."""
    masked = torch.where(mask > 0, scores, torch.inf)
    best = torch.argmin(masked, dim=-1)
    return _one_hot(best, mask.shape[-1]) * mask


def _uniform_policy(mask):
    k_valid = torch.clamp(mask.sum(dim=-1, keepdim=True), min=1.0)
    return mask / k_valid


def _vote_policy(greedy_choices, mask, n_policies, smooth=0.0):
    """Ensemble vote distribution (VW --bag / --cover): each policy's greedy
    choice (``greedy_choices`` ``[..., N]``) casts one vote; probabilities
    are vote fractions over valid actions, optionally mixed with ``smooth``
    * uniform (cover's residual uniform exploration)."""
    votes = _one_hot(greedy_choices, mask.shape[-1]).sum(dim=-2) / n_policies
    votes = votes * mask
    votes = (1.0 - smooth) * votes + smooth * _uniform_policy(mask)
    # renormalize over valid actions (votes on masked rows are dropped)
    denom = torch.clamp(votes.sum(dim=-1, keepdim=True), min=1e-38)
    return torch.where(mask.sum(dim=-1, keepdim=True) > 0, votes / denom,
                       votes)


def _cover_smooth(psi: float, t: float) -> float:
    """Cover's residual uniform share after ``t`` events,
    ``clip(psi / sqrt(t + 1), 0, 1)`` in f32."""
    r = np.float32(1.0) / np.sqrt(np.float32(t + 1.0))
    return float(np.clip(np.float32(psi) * r, np.float32(0.0),
                         np.float32(1.0)))


class _ContextualBanditParams(HasFeaturesCol, HasLabelCol, HasPredictionCol):
    device = Param("device", "Device to fit and score on: 'cuda' (default) "
                   "or 'cpu'", None, _to_device)
    sharedCol = Param("sharedCol", "column of shared-context vectors", "shared")
    additionalSharedFeatures = Param(
        "additionalSharedFeatures", "Extra shared-context vector columns "
        "concatenated onto sharedCol (reference: VowpalWabbitContextualBandit "
        "additionalSharedFeatures)", None, TypeConverters.to_list_string)
    chosenActionCol = Param("chosenActionCol",
                            "1-based index of the logged action",
                            "chosenAction")

    def _shared_block(self, dataset) -> np.ndarray:
        """Shared-context matrix: sharedCol plus any
        additionalSharedFeatures columns, concatenated feature-wise."""
        cols = [self.get_or_default("sharedCol")]
        cols += list(self.get_or_default("additionalSharedFeatures") or [])
        blocks = []
        for c in cols:
            b = np.asarray(dataset[c], dtype=np.float32)
            if b.ndim == 1:
                b = b[:, None]
            blocks.append(b)
        return blocks[0] if len(blocks) == 1 else np.concatenate(blocks,
                                                                 axis=1)
    probabilityCol = Param("probabilityCol",
                           "logged probability of the chosen action",
                           "probability")
    explorationPolicy = Param(
        "explorationPolicy",
        "cb_explore_adf exploration family (reference passes these through "
        "VW's args, VowpalWabbitBase.scala:77-81): 'epsilon' "
        "(epsilon-greedy), 'softmax' (p ~ exp(-lambda*score), "
        "softmaxLambda), 'bag' (bagSize bootstrap policies vote), 'cover' "
        "(coverSize diverse policies, online-cover cost adjustment with "
        "psi, residual uniform smoothing), 'first' (uniform for the first "
        "tau examples, then greedy)", "epsilon", TypeConverters.to_string)
    epsilon = Param("epsilon", "exploration epsilon", 0.05,
                    TypeConverters.to_float)
    softmaxLambda = Param("softmaxLambda",
                          "softmax temperature (VW --lambda)", 1.0,
                          TypeConverters.to_float)
    bagSize = Param("bagSize", "policies in the bag ensemble (VW --bag N)",
                    5, TypeConverters.to_int)
    coverSize = Param("coverSize", "policies in the cover ensemble "
                      "(VW --cover N)", 5, TypeConverters.to_int)
    psi = Param("psi", "cover diversity strength (VW --psi)", 1.0,
                TypeConverters.to_float)
    tau = Param("tau", "first-policy uniform-exploration horizon "
                "(VW --first tau)", 100, TypeConverters.to_int)
    learningRate = Param("learningRate", "sgd learning rate", 0.5,
                         TypeConverters.to_float)
    numPasses = Param("numPasses", "passes over the data", 1,
                      TypeConverters.to_int)
    useInteractions = Param("useInteractions",
                            "include the shared x action interaction block "
                            "(the ``-q sa`` VW flag; without it a linear ADF "
                            "scorer cannot condition actions on context)",
                            True, TypeConverters.to_bool)


class VowpalWabbitContextualBandit(Estimator, _ContextualBanditParams):
    """cb_explore_adf trainer (reference:
    VowpalWabbitContextualBandit.scala:108-260)."""

    parallelism = Param("parallelism", "threads for multi-config fit", 1,
                        TypeConverters.to_int)

    def _validate(self, dataset: Dataset):
        chosen = dataset.array(self.get_or_default("chosenActionCol"))
        if np.any(chosen == 0):
            raise ValueError("chosen action index is 1-based - cannot be 0 "
                             "(reference: VowpalWabbitContextualBandit.scala:232)")
        if np.any(chosen < 0):
            raise ValueError("chosen action index must be positive")
        counts = np.asarray([len(row) for row in
                             dataset[self.get_or_default("featuresCol")]])
        if np.any(chosen > counts):
            bad = int(np.argmax(chosen > counts))
            raise ValueError(
                f"row {bad}: chosen action {int(chosen[bad])} exceeds its "
                f"{int(counts[bad])} offered actions")
        probs = dataset.array(self.get_or_default("probabilityCol"))
        if np.any(probs <= 0):
            raise ValueError("logged probability must be > 0 for every row "
                             "(importance weights divide by it)")

    def _policy_size(self) -> int:
        policy = self.get_or_default("explorationPolicy")
        if policy in ("epsilon", "softmax", "first"):
            return 1
        if policy == "bag":
            return max(1, int(self.get_or_default("bagSize")))
        if policy == "cover":
            return max(1, int(self.get_or_default("coverSize")))
        raise ValueError(
            f"unknown explorationPolicy {policy!r}: use epsilon, "
            "softmax, bag, cover or first")

    def fit(self, dataset: Dataset) -> "VowpalWabbitContextualBanditModel":
        N = self._policy_size()
        dev = resolve_device(self.get_or_default("device"))
        self._validate(dataset)
        shared = self._shared_block(dataset)
        actions, mask = _stack_actions(
            dataset[self.get_or_default("featuresCol")])
        chosen = dataset.array(self.get_or_default("chosenActionCol")
                               ).astype(np.int64) - 1  # to 0-based
        cost = dataset.array(self.get_or_default("labelCol")).astype(np.float32)
        logged_p = dataset.array(self.get_or_default("probabilityCol")
                                 ).astype(np.float32)
        n = shared.shape[0]
        # bag: per-example per-policy Poisson(1) bootstrap weights (VW's
        # online bootstrap), deterministic seed
        if self.get_or_default("explorationPolicy") == "bag":
            boot = np.asarray(
                np.random.default_rng(0).poisson(1.0, size=(n, N)),
                np.float32)
        else:
            boot = np.ones((n, N), np.float32)
        state = _BanditState(
            N, shared.shape[1], actions.shape[2], actions.shape[1],
            bool(self.get_or_default("useInteractions")), dev)
        ev = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
              for a in (shared, actions, mask, chosen, cost, logged_p, boot)]
        cfg = _StepConfig.of(self, N)
        graph = _EventGraph(state, cfg, ev) if dev.type == "cuda" else None
        for _ in range(int(self.get_or_default("numPasses"))):
            if graph is not None:
                graph.run_pass()
                state.t += n
                continue
            for e in range(n):
                _example_step(state, cfg, state.t, *(a[e] for a in ev[:3]),
                              ev[3][e:e + 1], *(a[e] for a in ev[4:]))
                state.t += 1.0
        m = state.m.cpu().numpy().astype(np.float64)
        metrics = ContextualBanditMetrics(*(float(v) for v in m))
        model = VowpalWabbitContextualBanditModel(
            shared_weights=state.ws.cpu().numpy(),
            action_weights=state.wa.cpu().numpy(),
            interaction_weights=(state.wq.cpu().numpy()
                                 if state.wq is not None else None),
            metrics=metrics)
        self._copy_params_to(model)
        return model

    def fit_multiple(self, dataset: Dataset,
                     param_maps: List[Dict]) -> List["VowpalWabbitContextualBanditModel"]:
        """Fit one model per param map on a thread pool (reference:
        VowpalWabbitContextualBandit.fit(dataset, paramMaps):268-285)."""
        n_jobs = int(self.get_or_default("parallelism"))

        def fit_one(pm: Dict):
            est = VowpalWabbitContextualBandit()
            self._copy_params_to(est)
            est.set(**pm)
            return est.fit(dataset)

        if n_jobs <= 1:
            return [fit_one(pm) for pm in param_maps]
        with ThreadPoolExecutor(max_workers=n_jobs) as pool:
            return list(pool.map(fit_one, param_maps))


class _StepConfig:
    """The constants of one fit's example step."""

    @classmethod
    def of(cls, est: "VowpalWabbitContextualBandit", N: int):
        c = cls()
        c.N = N
        c.policy = est.get_or_default("explorationPolicy")
        c.eps = float(est.get_or_default("epsilon"))
        c.lr = float(est.get_or_default("learningRate"))
        c.lam = float(est.get_or_default("softmaxLambda"))
        c.psi = float(est.get_or_default("psi"))
        c.tau = int(est.get_or_default("tau"))
        return c


class _BanditState:
    """An ensemble of N linear scorers, their AdaGrad accumulators, the
    IPS/SNIPS counters ``m`` (snips numerator, total events, snips
    denominator, offline events, max ips term) and the event clock."""

    def __init__(self, N, d_s, d_a, K, interact, dev):
        def z(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=dev)
        self.ws, self.wa, self.g2s, self.g2a = (z(N, d_s), z(N, d_a),
                                                z(N, d_s), z(N, d_a))
        self.wq = z(N, d_s, d_a) if interact else None
        self.g2q = z(N, d_s, d_a) if interact else None
        self.m = z(5)
        self.t = 0.0
        self.K = K
        self.member = torch.arange(N, device=dev, dtype=torch.float32)


def _example_step(st: _BanditState, cfg: _StepConfig, t, xs, xa, amask,
                  k_star, c, p_log, bw) -> None:
    """One example (the JAX ``example_step``) at event clock ``t`` (a host
    float, or a 0-d f32 tensor on the device in a captured graph): ``xs
    [d_s]``, ``xa [K, d_a]``, ``amask [K]``, ``k_star [1]`` (0-based, a
    tensor so nothing is read back), cost ``c``, logged probability
    ``p_log``, bootstrap weights ``bw [N]``. Updates ``st``'s tensors in
    place."""
    on_device = isinstance(t, torch.Tensor)
    # per-policy scores [N, K]
    scores = ((st.wa[:, None, :] * xa[None, :, :]).sum(dim=-1)
              + (st.ws * xs).sum(dim=-1)[:, None])
    if st.wq is not None:
        hq = (xs[None, :, None] * st.wq).sum(dim=1)            # [N, d_a]
        scores = scores + (hq[:, None, :] * xa[None, :, :]).sum(dim=-1)
    masked = torch.where(amask[None, :] > 0, scores, torch.inf)
    greedy = torch.argmin(masked, dim=-1)                      # [N]
    if cfg.policy == "epsilon":
        probs = _epsilon_greedy(scores[0], amask, cfg.eps)
    elif cfg.policy == "softmax":
        probs = _softmax_policy(scores[0], amask, cfg.lam)
    elif cfg.policy == "first":
        if on_device:
            probs = torch.where(t < cfg.tau, _uniform_policy(amask),
                                _greedy_policy(scores[0], amask))
        else:
            probs = (_uniform_policy(amask) if t < cfg.tau
                     else _greedy_policy(scores[0], amask))
    else:
        if cfg.policy != "cover":
            smooth = 0.0
        elif on_device:
            smooth = torch.clamp(cfg.psi * torch.rsqrt(t + 1.0), 0.0, 1.0)
        else:
            smooth = _cover_smooth(cfg.psi, t)
        probs = _vote_policy(greedy, amask, cfg.N, smooth)
    p_eval = probs.index_select(0, k_star)[0]

    # IPS/SNIPS counters (reference addExample semantics)
    p_over_p = p_eval / p_log
    live = (p_eval > 0).to(torch.float32)
    ips = live * c * p_over_p
    m = st.m
    m.copy_(torch.stack((m[0] + ips, m[1] + 1.0, m[2] + live * p_over_p,
                         m[3] + live, torch.maximum(m[4], ips))))

    # MTR update on the chosen action, importance 1/p_log, every member
    x_a = xa.index_select(0, k_star)[0]
    s_k = scores.index_select(1, k_star)[:, 0]                 # [N]
    if cfg.policy == "cover" and cfg.N > 1:
        # online-cover diversity (Agarwal et al. 2014; VW --cover --psi):
        # discount member i's cost by how rarely the members before it
        # pick the logged action
        hits = (greedy == k_star).to(torch.float32)
        prev = torch.cumsum(hits, dim=0) - hits
        p_prev = torch.clamp(prev / st.member, min=1.0 / st.K)
        ci = torch.where(st.member > 0, c - cfg.psi / (st.K * p_prev), c)
    else:
        ci = c
    grad = bw * (s_k - ci) / p_log                             # [N]
    gs = grad[:, None] * xs[None, :]
    ga = grad[:, None] * x_a[None, :]
    st.g2s.add_(gs * gs)
    st.g2a.add_(ga * ga)
    st.ws.add_(gs * -cfg.lr * torch.rsqrt(st.g2s + 1e-6))
    st.wa.add_(ga * -cfg.lr * torch.rsqrt(st.g2a + 1e-6))
    if st.wq is not None:
        gq = torch.outer(xs, x_a)[None, :, :] * grad[:, None, None]
        st.g2q.add_(gq * gq)
        st.wq.add_(gq * -cfg.lr * torch.rsqrt(st.g2q + 1e-6))


class _EventGraph:
    """One example step captured as a CUDA graph over the device-resident
    events: a device counter picks the event and the device clock advances
    inside the graph, so a pass is ``n`` replays (one launch each) instead
    of some 60 kernel launches an event from the host. The ensemble's
    tensors are the graph's static inputs and are updated in place."""

    def __init__(self, st: _BanditState, cfg: _StepConfig, ev):
        dev = st.ws.device
        self.n = ev[0].shape[0]
        self.e = torch.zeros(1, dtype=torch.int64, device=dev)
        self.t = torch.tensor(st.t, dtype=torch.float32, device=dev)
        state = [a for a in (st.ws, st.wa, st.wq, st.g2s, st.g2a, st.g2q,
                             st.m) if a is not None]

        def body():
            xs, xa, amask = (a.index_select(0, self.e)[0] for a in ev[:3])
            k_star = ev[3].index_select(0, self.e)
            c, p_log, bw = (a.index_select(0, self.e)[0] for a in ev[4:])
            _example_step(st, cfg, self.t, xs, xa, amask, k_star, c, p_log,
                          bw)
            self.t.add_(1.0)
            self.e.add_(1)

        self.graph = capture_graph(body, state + [self.t, self.e], dev)

    def run_pass(self) -> None:
        self.e.zero_()
        for _ in range(self.n):
            self.graph.replay()


class VowpalWabbitContextualBanditModel(Model, _ContextualBanditParams):
    """Scores actions and emits the exploration probability vector per row
    (reference: VowpalWabbitContextualBanditModel.transform:305-350)."""

    sharedWeights = Param("sharedWeights", "shared linear block", None,
                          is_complex=True)
    actionWeights = Param("actionWeights", "ADF action linear block", None,
                          is_complex=True)
    interactionWeights = Param("interactionWeights",
                               "shared x action interaction block", None,
                               is_complex=True)

    def __init__(self, shared_weights: Optional[np.ndarray] = None,
                 action_weights: Optional[np.ndarray] = None,
                 interaction_weights: Optional[np.ndarray] = None,
                 metrics: Optional[ContextualBanditMetrics] = None, **kwargs):
        super().__init__(**kwargs)
        if shared_weights is not None:
            self.set(sharedWeights=np.asarray(shared_weights))
        if action_weights is not None:
            self.set(actionWeights=np.asarray(action_weights))
        if interaction_weights is not None:
            self.set(interactionWeights=np.asarray(interaction_weights))
        self.metrics = metrics or ContextualBanditMetrics()

    def get_performance_statistics(self) -> Dataset:
        m = self.metrics
        return Dataset({
            "ipsEstimate": np.asarray([m.get_ips_estimate()
                                       if m.total_events else np.nan]),
            "snipsEstimate": np.asarray([m.get_snips_estimate()
                                         if m.snips_denominator else np.nan]),
            "totalEvents": np.asarray([m.total_events]),
            "offlinePolicyEvents": np.asarray([m.offline_policy_events]),
        })

    def transform(self, dataset: Dataset) -> Dataset:
        dev = resolve_device(self.get_or_default("device"))
        ws = np.asarray(self.get_or_default("sharedWeights"))
        wa = np.asarray(self.get_or_default("actionWeights"))
        if ws.ndim == 1:      # models saved before the ensemble layout
            ws, wa = ws[None, :], wa[None, :]
        shared = self._shared_block(dataset)
        actions, mask = _stack_actions(
            dataset[self.get_or_default("featuresCol")])
        policy = self.get_or_default("explorationPolicy")
        N = ws.shape[0]

        # per-policy scores [n, N, K], on the host as the JAX model's
        scores = (np.einsum("nkd,pd->npk", actions, wa)
                  + np.einsum("ns,ps->np", shared, ws)[:, :, None])
        wq = self.get_or_default("interactionWeights")
        if wq is not None:
            wq = np.asarray(wq)
            if wq.ndim == 2:
                wq = wq[None, :, :]
            scores = scores + np.einsum("ns,psd,nkd->npk", shared, wq,
                                        actions)
        t_seen = float(self.metrics.total_events)
        mask_d = torch.from_numpy(mask).to(dev)

        def lead():
            return torch.from_numpy(
                np.ascontiguousarray(scores[:, 0])).to(dev)

        # one policy definition shared with training (no train/serve drift)
        if policy == "softmax":
            probs = _softmax_policy(
                lead(), mask_d, float(self.get_or_default("softmaxLambda")))
        elif policy == "first":
            # exploit only once training consumed its tau uniform examples;
            # a model fit on fewer is still in the uniform phase (VW --first)
            if t_seen < int(self.get_or_default("tau")):
                probs = _uniform_policy(mask_d)
            else:
                probs = _greedy_policy(lead(), mask_d)
        elif policy in ("bag", "cover"):
            masked = np.where(mask[:, None, :] > 0, scores, np.inf)
            greedy = torch.from_numpy(masked.argmin(axis=-1)).to(dev)
            # same vote + smoothing definition as training (cover's decay
            # evaluated at the end-of-training event count)
            smooth = (float(np.clip(
                float(self.get_or_default("psi")) / (t_seen + 1.0) ** 0.5,
                0.0, 1.0)) if policy == "cover" else 0.0)
            probs = _vote_policy(greedy, mask_d, N, smooth)
        else:
            probs = _epsilon_greedy(
                lead(), mask_d, float(self.get_or_default("epsilon")))
        probs = probs.cpu().numpy()
        out = [probs[i, mask[i] > 0].tolist() for i in range(len(probs))]
        return dataset.with_column(
            self.get_or_default("predictionCol") or "prediction", out)

    def _save_extra(self, path: str) -> None:
        import json
        import os
        m = self.metrics
        with open(os.path.join(path, "metrics.json"), "w") as f:
            json.dump(vars(m), f)

    def _load_extra(self, path: str) -> None:
        import json
        import os
        p = os.path.join(path, "metrics.json")
        self.metrics = ContextualBanditMetrics()
        if os.path.exists(p):
            with open(p) as f:
                self.metrics.__dict__.update(json.load(f))


class VectorZipper(Transformer, HasInputCols, HasOutputCol):
    """Combine input columns into a per-row sequence — the action-assembly
    step for ADF (reference: vw/VectorZipper.scala)."""

    def transform(self, dataset: Dataset) -> Dataset:
        cols = [dataset[c] for c in self.get_or_default("inputCols")]
        zipped = [[col[i] for col in cols] for i in range(len(dataset))]
        return dataset.with_column(self.get_or_default("outputCol"), zipped)


class VowpalWabbitInteractions(Transformer, HasInputCols, HasOutputCol):
    """FNV-1 cross-namespace interaction features over dense vector columns
    (reference: vw/VowpalWabbitInteractions.scala — the ``-q`` analog for
    non-VW learners). Emits hashed sparse ``{out}_indices/{out}_values``."""

    numBits = Param("numBits", "feature space is 2^numBits", 18,
                    TypeConverters.to_int)
    sumCollisions = Param("sumCollisions", "sum values on hash collision",
                          True, TypeConverters.to_bool)

    def transform(self, dataset: Dataset) -> Dataset:
        fnv_prime = 16777619
        num_bits = int(self.get_or_default("numBits"))
        mask = (1 << num_bits) - 1
        sum_coll = self.get_or_default("sumCollisions")
        in_cols = self.get_or_default("inputCols")
        mats = [np.asarray(dataset[c], dtype=np.float64) for c in in_cols]
        for m in mats:
            if m.ndim != 2:
                raise ValueError("VowpalWabbitInteractions needs dense "
                                 "vector columns of shape [n, d]")

        n = len(dataset)
        rows: List[Dict[int, float]] = []
        nnz_max = 1
        for i in range(n):
            active = []
            for m in mats:
                nz = np.nonzero(m[i])[0]
                active.append([(int(j), float(m[i, j])) for j in nz])
            acc: Dict[int, float] = {}

            def interact(idx: int, value: float, ns: int):
                if ns == len(active):
                    key = mask & idx
                    if key in acc and sum_coll:
                        acc[key] += value
                    else:
                        acc[key] = value
                    return
                idx1 = (idx * fnv_prime) & 0xFFFFFFFF
                for j, v in active[ns]:
                    interact(idx1 ^ j, value * v, ns + 1)

            interact(0, 1.0, 0)
            rows.append(acc)
            nnz_max = max(nnz_max, len(acc))

        indices = np.zeros((n, nnz_max), dtype=np.int32)
        values = np.zeros((n, nnz_max), dtype=np.float32)
        for i, acc in enumerate(rows):
            if acc:
                indices[i, :len(acc)] = np.fromiter(acc.keys(), np.int32,
                                                    len(acc))
                values[i, :len(acc)] = np.fromiter(acc.values(), np.float32,
                                                   len(acc))
        out = self.get_or_default("outputCol")
        return dataset.with_columns({f"{out}_indices": indices,
                                     f"{out}_values": values})
