"""Typed state shared by every federated NAS runtime.

``CommStats`` accounts both the training-phase traffic (sub-model
downloads/uploads, Algorithm 3/4) and the evaluation-phase traffic the
paper's Section IV.G comparison needs: the 2N choice-key downloads before
fitness evaluation and the per-client error-count uploads afterwards.
Every byte is counted twice, as fp32-*logical* bytes (``BYTES_PER_PARAM``
per parameter — the paper's Section IV.G unit) and as *wire* bytes, what
the ``RunConfig.uplink_codec`` / ``downlink_codec`` payload codecs put on
the network; with ``"none"`` codecs the two are equal.
``RoundReport`` is the typed per-round history record every strategy
produces; ``history_dict`` flattens a list of reports into a
dict-of-lists.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.obs.telemetry import TelemetryConfig, TelemetryResult

BYTES_PER_PARAM = 4        # float32 logical payloads
ERROR_COUNT_BYTES = 4      # one int32 error count per evaluated sub-model


# Algorithm 3 routes: "torch" is the JAX package's "xla" tree route,
# "kernel" its "pallas" flat route (the hand-written CUDA kernel)
AGGREGATE_BACKENDS = ("torch", "kernel")


@dataclasses.dataclass
class ClientSimConfig:
    """Real-time client availability / heterogeneity simulation.

    The paper's headline claim is *real-time* federated NAS: mobile
    clients come and go, and double sampling plus weight inheritance
    keep the search stable despite that.  This config models the three
    failure modes the FedNAS literature singles out, all drawn from a
    dedicated RNG stream (``seed``) so the *search* trajectory
    (participant sampling, offspring variation) never shifts when the
    simulation knobs change:

      * ``availability`` — probability that a sampled client actually
        checks in this round (it never receives a download otherwise).
        ``availability_trace`` optionally gives one probability per
        client (device classes: phones vs. plugged-in tablets),
        overriding the scalar.  ``availability_dist`` instead draws each
        client's per-round check-in probability from a compact
        distribution spec — ``("bernoulli", q)`` (a ``q`` fraction of
        clients are always on, the rest never), ``("uniform", lo, hi)``
        or ``("beta", a, b)`` — keyed by a counter-based per-client
        stream, so a 10^6-client fleet costs O(1) state instead of a
        length-``num_clients`` trace array; mutually exclusive with
        ``availability_trace``.
      * ``dropout`` — probability that a checked-in client fails
        *after* its downloads but *before* any upload: its local
        training is lost (excluded from aggregation, no upload bytes),
        it reports no evaluation counts, and every byte pushed to it
        this round lands on the ``CommStats`` wasted ledger.
      * ``straggler_fraction`` / ``straggler_slowdown`` /
        ``round_deadline`` — a fixed ``straggler_fraction`` of clients
        run ``straggler_slowdown``× slower; per round each checked-in
        client finishes at ``speed × U(0.8, 1.2)`` (1.0 = a nominal
        round) and clients past ``round_deadline`` miss the round's
        aggregation — same consequence as ``dropout``.  ``None``
        disables the deadline.

    The defaults simulate nothing: ``ClientSimConfig()`` reproduces the
    fully-synchronous trajectories bit for bit (no sim RNG is even
    drawn).
    """
    availability: float = 1.0
    availability_trace: Optional[tuple] = None   # per-client P(available)
    availability_dist: Optional[tuple] = None    # compact per-client spec
    dropout: float = 0.0
    straggler_fraction: float = 0.0
    straggler_slowdown: float = 1.0
    round_deadline: Optional[float] = None
    seed: int = 0

    def __post_init__(self):
        if not 0.0 < self.availability <= 1.0:
            raise ValueError(
                f"availability must be in (0, 1], got {self.availability}")
        if self.availability_trace is not None:
            trace = tuple(float(p) for p in self.availability_trace)
            if not all(0.0 <= p <= 1.0 for p in trace):
                raise ValueError("availability_trace entries must be in "
                                 f"[0, 1], got {trace}")
            self.availability_trace = trace
        if self.availability_dist is not None:
            if self.availability_trace is not None:
                raise ValueError("availability_dist and availability_trace "
                                 "are mutually exclusive — pick one")
            dist = tuple(self.availability_dist)
            if not dist or not isinstance(dist[0], str):
                raise ValueError(
                    "availability_dist must be ('bernoulli', q) | "
                    f"('uniform', lo, hi) | ('beta', a, b), got {dist!r}")
            name, params = dist[0], tuple(float(p) for p in dist[1:])
            if name == "bernoulli":
                if len(params) != 1 or not 0.0 <= params[0] <= 1.0:
                    raise ValueError("('bernoulli', q) needs one q in "
                                     f"[0, 1], got {dist!r}")
            elif name == "uniform":
                if (len(params) != 2
                        or not 0.0 <= params[0] <= params[1] <= 1.0):
                    raise ValueError("('uniform', lo, hi) needs "
                                     f"0 <= lo <= hi <= 1, got {dist!r}")
            elif name == "beta":
                if len(params) != 2 or min(params) <= 0.0:
                    raise ValueError("('beta', a, b) needs a, b > 0, "
                                     f"got {dist!r}")
            else:
                raise ValueError(
                    f"unknown availability_dist {name!r}: expected "
                    "'bernoulli', 'uniform' or 'beta'")
            self.availability_dist = (name,) + params
        if not 0.0 <= self.dropout <= 1.0:
            raise ValueError(
                f"dropout must be in [0, 1], got {self.dropout}")
        if not 0.0 <= self.straggler_fraction <= 1.0:
            raise ValueError(f"straggler_fraction must be in [0, 1], "
                             f"got {self.straggler_fraction}")
        if self.straggler_slowdown < 1.0:
            raise ValueError(f"straggler_slowdown must be >= 1, "
                             f"got {self.straggler_slowdown}")
        if self.round_deadline is not None and self.round_deadline <= 0:
            raise ValueError(f"round_deadline must be > 0 or None, "
                             f"got {self.round_deadline}")
        if self.straggler_fraction > 0.0 and self.round_deadline is None:
            raise ValueError(
                "straggler_fraction > 0 does nothing without a "
                "round_deadline (stragglers only miss rounds against a "
                "deadline) — set round_deadline or drop the stragglers")

    @property
    def is_active(self) -> bool:
        """Whether any knob deviates from the fully-synchronous world.
        Inactive configs take the exact legacy engine path."""
        return (self.availability < 1.0
                or self.availability_trace is not None
                or self.availability_dist is not None
                or self.dropout > 0.0
                or self.round_deadline is not None)


@dataclasses.dataclass
class RunConfig:
    """Every knob of a federated NAS run, validated at construction.

    Search / schedule:
      * ``population`` — N, individuals per generation (Algorithm 4).
      * ``generations`` — rounds to run (one NSGA-II generation == one
        federated communication round).
      * ``participation`` — C in the paper: fraction of clients sampled
        each round (m = round(C * K) participants).
      * ``lr0`` / ``lr_decay`` — client SGD learning rate, decayed as
        ``lr0 * lr_decay**(gen - 1)`` per round (rounded to float32).
      * ``momentum`` / ``local_epochs`` — client-side SGD momentum and
        number of local passes E over the client shard per round.
      * ``crossover`` / ``mutation`` — per-offspring probabilities of the
        two variation operators (Algorithm 2).
      * ``seed`` — seeds both participant/group sampling and model init.

    Execution:
      * ``aggregate_backend`` — how Algorithm 3 (fill-aggregation) is
        computed: ``"kernel"`` (the hand-written CUDA kernel on a flat
        parameter vector; its plain PyTorch version for a master on the
        CPU) or ``"torch"`` (leaf by leaf in PyTorch).  Unknown values
        raise here, at config time.
      * ``backend`` — client-execution backend: ``"loop"`` (one local
        update per (individual, client) pair), ``"vmap"``
        (``ClientBatch``-stacked shards on the device; a group's clients
        train in turn from one stack, evaluation runs under
        ``torch.func.vmap``, O(population) batched calls per
        generation) or ``"mesh"`` (the same stacks with the population
        axis split over the devices of ``launch.mesh.make_host_mesh``:
        every visible card, or one CPU device on ``"cpu"``; pass
        ``FedEngine(..., backend=MeshBackend(..., mesh=...))`` for
        another mesh).  Validated when the engine builds the
        backend.
      * ``vmap_eval_tile`` — clients evaluated together per inner
        ``vmap`` tile in the batched backend's forward-only evaluation
        (>= 1).  Tiling never changes results: error counts are
        integers, so any client-axis batching gives the same totals.
      * ``fused`` — run each generation of the batched backend as a
        constant number of batched calls ("dispatches", each one call of
        a batched program): one per ``train_fill`` (local SGD of every
        group, the per-group weighting and the Algorithm 3 partial sums;
        on CUDA the new master is written into the previous master's
        own tensors when nothing reads them afterwards,
        ``master_donation_safe``) and one per evaluation call (every key
        -> one on-device wrong-count vector, read by the host once).  On
        the ``"kernel"`` route a fused ``train_fill`` is one call for
        every group's uploads (on ``"mesh"`` one per shape bucket, fused
        or not), then one K1 launch per shape bucket.
        Defaults to True; ``False`` restores the per-bucket / per-key
        calls.  Ignored by the ``"loop"`` backend.
      * ``device`` — where the master, the client shards and all training
        run: ``"cuda"`` (the default) or ``"cpu"``.  The engine raises if
        ``"cuda"`` is asked for and no GPU is present; it never moves to
        the CPU on its own.

    Client availability (``client_sim``):
      * a ``ClientSimConfig`` (also accepted as a plain dict) modeling
        real-time device behavior — per-round availability, post-download
        dropout, stragglers against a round deadline.  The default
        simulates nothing.

    Communication (``repro_torch.comm``; validated here like
    ``aggregate_backend``):
      * ``uplink_codec`` — payload codec for client->server transfers
        (trained sub-model uploads).  ``"none"`` (fp32), ``"cast"`` /
        ``"cast:bf16"`` / ``"cast:fp16"`` (16-bit float), ``"int8"`` /
        ``"int8:kernel"`` / ``"int8:torch"`` (per-tensor symmetric
        quantization, on the hand-written CUDA kernels or in plain
        PyTorch), ``"topk"`` / ``"topk:<ratio>"`` (magnitude
        sparsification).  Lossy uplink codecs compose with server-side
        error feedback on the persistent-model paths.
      * ``downlink_codec`` — same spec grammar for server->client
        transfers (master broadcasts / sub-model downloads).

    Observability (``telemetry``):
      * a ``repro_torch.obs.TelemetryConfig`` (also accepted as a plain
        dict, or ``True`` for all defaults; ``False`` means off) turning
        on phase spans, per-program signature counters, resource gauges
        and structured per-round events on ``EngineResult.telemetry``.
        The default ``None`` means off: the engine builds the object
        graph it builds without telemetry, and runs are bit for bit the
        same either way (``tests/test_torch_obs.py``).
    """
    population: int = 10
    generations: int = 500
    participation: float = 1.0          # C in the paper
    lr0: float = 0.1
    lr_decay: float = 0.995
    momentum: float = 0.5
    local_epochs: int = 1
    crossover: float = 0.9
    mutation: float = 0.1
    seed: int = 0
    aggregate_backend: str = "kernel"   # Algorithm 3 route: 'torch' | 'kernel'
    backend: str = "loop"               # execution: 'loop' | 'vmap' | 'mesh'
    vmap_eval_tile: int = 32            # clients vmapped per eval tile
    fused: bool = True                  # one call per generation phase
    device: str = "cuda"                # 'cuda' | 'cpu'
    uplink_codec: str = "none"          # client->server payload codec
    downlink_codec: str = "none"        # server->client payload codec
    client_sim: ClientSimConfig = dataclasses.field(
        default_factory=ClientSimConfig)   # availability / dropout model
    telemetry: Optional[TelemetryConfig] = None   # obs (None = off)

    def __post_init__(self):
        if self.client_sim is None:
            self.client_sim = ClientSimConfig()
        elif isinstance(self.client_sim, dict):
            self.client_sim = ClientSimConfig(**self.client_sim)
        if self.telemetry is True:
            self.telemetry = TelemetryConfig()
        elif self.telemetry is False:
            self.telemetry = None
        elif isinstance(self.telemetry, dict):
            self.telemetry = TelemetryConfig(**self.telemetry)
        if self.aggregate_backend not in AGGREGATE_BACKENDS:
            raise ValueError(
                f"unknown aggregate_backend {self.aggregate_backend!r}; "
                f"available: {list(AGGREGATE_BACKENDS)}")
        if self.vmap_eval_tile < 1:
            raise ValueError(
                f"vmap_eval_tile must be >= 1, got {self.vmap_eval_tile}")
        try:
            dev = torch.device(self.device)
        except RuntimeError as e:
            raise ValueError(f"bad device {self.device!r}: {e}") from None
        if dev.type not in ("cpu", "cuda"):
            raise ValueError(
                f"device must be 'cuda' or 'cpu', got {self.device!r}")
        if not 0.0 < self.participation <= 1.0:
            raise ValueError(
                f"participation must be in (0, 1], got {self.participation}")
        if self.population < 2:
            raise ValueError(
                f"population must be >= 2 (NSGA-II needs parents to "
                f"recombine), got {self.population}")
        if self.lr0 < 0:
            raise ValueError(f"lr0 must be >= 0, got {self.lr0}")
        if self.local_epochs < 0:
            raise ValueError(
                f"local_epochs must be >= 0, got {self.local_epochs}")
        # codec specs fail here, at config time (ValueError lists the
        # available names)
        from repro_torch.comm import make_codec
        make_codec(self.uplink_codec)
        make_codec(self.downlink_codec)


@dataclasses.dataclass
class CommStats:
    """Cumulative server<->client traffic and compute of one run.

    Every transfer is counted on two ledgers, both independent of the
    execution backend (accounting lives in the strategies, never in the
    dispatch layer — so all backends produce identical CommStats for the
    same seed and codec):

      * **logical bytes** (``down_bytes`` / ``up_bytes`` and the eval
        subsets) — fp32 payloads, ``BYTES_PER_PARAM`` per parameter: the
        paper's Section IV.G cost unit, independent of the codec, so
        cost comparisons against the paper survive any compression
        setting.
      * **wire bytes** (``down_wire_bytes`` / ``up_wire_bytes``) — what
        the payload codecs put on the network.  With ``"none"`` codecs
        (the only ones ported so far) wire == logical.  Choice keys and error counts are already minimal
        encodings and cross the wire uncompressed on both ledgers.

    Fields:
      * ``down_bytes``   — total logical server->client bytes: sub-model
        payload downloads (training phase) PLUS the evaluation-phase
        master / choice-key downloads.
      * ``up_bytes``     — total logical client->server bytes: sub-model
        uploads PLUS the evaluation-phase error-count uploads.
      * ``down_wire_bytes`` / ``up_wire_bytes`` — the same transfers at
        codec wire size.
      * ``client_train_passes`` — number of (individual, client) local
        training passes (E local epochs each), the paper's compute unit.
      * ``eval_down_bytes`` / ``eval_up_bytes`` — the fitness-phase
        subset of down/up_bytes: per participant, the
        master download (real-time strategy only), 2N choice keys down
        (``SupernetAPI.key_bytes`` each) and one int32 error count per
        evaluated key up.  Always <= the corresponding totals.
      * ``wasted_down_bytes`` / ``wasted_down_wire_bytes`` — the subset
        of down/down_wire_bytes pushed to clients that later dropped
        out of the round (``ClientSimConfig.dropout`` / missed
        ``round_deadline``): bytes the server spent for nothing.
        Uploads have no wasted ledger — a dropped client never uploads.
        ``client_train_passes`` *does* include passes whose upload was
        lost: the device spent that compute before failing.
    """
    down_bytes: float = 0.0
    up_bytes: float = 0.0
    client_train_passes: int = 0
    eval_down_bytes: float = 0.0        # subset of down_bytes (fitness phase)
    eval_up_bytes: float = 0.0          # subset of up_bytes (fitness phase)
    down_wire_bytes: float = 0.0        # codec wire size of down_bytes
    up_wire_bytes: float = 0.0          # codec wire size of up_bytes
    wasted_down_bytes: float = 0.0      # downloads to clients that dropped
    wasted_down_wire_bytes: float = 0.0  # the same at codec wire size

    def add_download(self, params: int, copies: int = 1,
                     wire_bytes: Optional[float] = None,
                     wasted_copies: int = 0):
        """Account ``copies`` sub-model downloads of ``params`` params;
        ``wire_bytes`` is the per-payload codec wire size (defaults to
        the fp32-logical size).  ``wasted_copies`` of them (<= copies)
        went to clients that later dropped and are additionally booked
        on the wasted ledger."""
        wire = BYTES_PER_PARAM * params if wire_bytes is None else wire_bytes
        self.down_bytes += BYTES_PER_PARAM * params * copies
        self.down_wire_bytes += wire * copies
        self.wasted_down_bytes += BYTES_PER_PARAM * params * wasted_copies
        self.wasted_down_wire_bytes += wire * wasted_copies

    def add_upload(self, params: int, copies: int = 1,
                   wire_bytes: Optional[float] = None):
        """Account ``copies`` sub-model uploads of ``params`` params;
        ``wire_bytes`` as in ``add_download``."""
        self.up_bytes += BYTES_PER_PARAM * params * copies
        self.up_wire_bytes += (BYTES_PER_PARAM * params
                               if wire_bytes is None
                               else wire_bytes) * copies

    def add_eval_download_bytes(self, nbytes: float, copies: int = 1,
                                wire_nbytes: Optional[float] = None,
                                wasted_copies: int = 0):
        """Account fitness-phase downloads of ``nbytes`` logical bytes
        each (``wire_nbytes`` at codec size; defaults to ``nbytes``);
        ``wasted_copies`` as in ``add_download``."""
        wire = nbytes if wire_nbytes is None else wire_nbytes
        self.down_bytes += nbytes * copies
        self.eval_down_bytes += nbytes * copies
        self.down_wire_bytes += wire * copies
        self.wasted_down_bytes += nbytes * wasted_copies
        self.wasted_down_wire_bytes += wire * wasted_copies

    def add_eval_upload_bytes(self, nbytes: float, copies: int = 1,
                              wire_nbytes: Optional[float] = None):
        """Account fitness-phase uploads of ``nbytes`` logical bytes
        each (``wire_nbytes`` at codec size; defaults to ``nbytes``)."""
        self.up_bytes += nbytes * copies
        self.eval_up_bytes += nbytes * copies
        self.up_wire_bytes += (nbytes if wire_nbytes is None
                               else wire_nbytes) * copies


@dataclasses.dataclass
class RoundReport:
    """One federated round (== one NSGA-II generation for the NAS
    strategies).  Search fields a strategy does not produce stay ``None``
    and are dropped from the legacy history dict.

    Search fields (strategy-produced): ``objs`` is the (2N, 2) objective
    matrix [weighted test-error rate in [0, 1], forward FLOPs/MACs of the
    subnet]; ``parent_keys`` the N selected choice keys; ``best_*`` /
    ``knee_*`` the error (rate) and key of the lowest-error and
    knee-point individuals of the selected front.

    Engine-stamped fields: ``down_gb`` / ``up_gb`` are the CUMULATIVE
    CommStats totals in gigabytes (1e9 bytes) at the end of this round;
    ``train_passes`` the cumulative (individual, client) local training
    passes.  ``wall_s`` is CUMULATIVE: seconds since ``run()`` started
    (kept cumulative for the legacy history layout — it is *not* a
    per-round time); ``round_s`` is this round's wall-clock delta, the
    per-generation number benchmarks and steady-state comparisons
    want.

    Availability fields (stamped only when ``ClientSimConfig`` is
    active, ``None`` — and absent from the history dict — otherwise):
    ``n_sampled`` clients drawn by participation sampling,
    ``n_available`` of them checked in, ``n_dropped`` failed after
    download but before upload (dropout or missed deadline),
    ``n_survivors`` completed the round; ``wasted_down_gb`` is the
    cumulative wasted-download ledger in gigabytes."""
    gen: int
    objs: Optional[np.ndarray] = None          # (2N, 2) [err, flops]
    parent_keys: Optional[List[np.ndarray]] = None
    best_err: Optional[float] = None
    best_key: Optional[np.ndarray] = None
    knee_err: Optional[float] = None
    knee_key: Optional[np.ndarray] = None
    # stamped by the engine after the strategy returns:
    down_gb: float = 0.0
    up_gb: float = 0.0
    train_passes: int = 0
    wall_s: float = 0.0      # cumulative since run() start
    round_s: float = 0.0     # this round's wall-clock delta
    # client-availability simulation (None unless ClientSimConfig active):
    n_sampled: Optional[int] = None     # drawn by participation sampling
    n_available: Optional[int] = None   # actually checked in
    n_dropped: Optional[int] = None     # failed after download, pre-upload
    n_survivors: Optional[int] = None   # completed every upload
    wasted_down_gb: Optional[float] = None   # cumulative wasted ledger


HISTORY_FIELDS = ("gen", "objs", "parent_keys", "best_err", "knee_err",
                  "best_key", "knee_key", "down_gb", "up_gb",
                  "train_passes", "wall_s", "round_s", "n_sampled",
                  "n_available", "n_dropped", "n_survivors",
                  "wasted_down_gb")


def append_report(hist: Dict[str, list], report: RoundReport) -> None:
    """Append one round to a legacy dict-of-lists history in place
    (fields the strategy does not produce are dropped)."""
    for f in HISTORY_FIELDS:
        v = getattr(report, f)
        if v is not None:
            hist.setdefault(f, []).append(v)


def history_dict(reports: List[RoundReport]) -> Dict[str, list]:
    """Legacy dict-of-lists view (keys with all-None values are dropped)."""
    out: Dict[str, list] = {}
    for r in reports:
        append_report(out, r)
    return out


@dataclasses.dataclass
class EngineResult:
    reports: List[RoundReport]
    stats: CommStats
    extras: Dict
    # collected telemetry (None unless RunConfig.telemetry was enabled):
    # the retained RoundEvent ring + final per-program signature counts
    telemetry: Optional[TelemetryResult] = None

    def history(self) -> Dict:
        out = history_dict(self.reports)
        out.update(self.extras)
        out["stats"] = self.stats
        return out
