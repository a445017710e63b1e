"""Traffic scenario library: packet-trace generators for the dataplane.

Each scenario synthesizes packet headers whose bits are the BNN's input
activations, so benchmarks and differential tests exercise the executor on
realistic bit *distributions* — not just uniform noise.  The scenarios mirror
the workloads the in-network-NN literature actually classifies:

* ``flow_tuple``   — per-packet 5-tuples drawn from a heavy-tailed flow pool
  (flow classification: few elephants, many mice; headers repeat).
* ``ddos_burst``   — background traffic with periodic attack bursts of a
  jittered attacker signature (anomaly/DDoS detection: regime shifts).
* ``iot_telemetry``— a small device fleet reporting slowly-drifting
  Gray-coded sensor readings (low bit-entropy, strong temporal locality).
* ``adversarial_bitflip`` — prototype inputs with a few random bit flips
  (decision-boundary robustness probes).
* ``uniform_random`` — i.i.d. fair coin bits (the null workload).

Beyond the built-in synthetic five, :func:`register_scenario` admits new
scenarios at runtime — ``dataplane.pcap`` uses it to register *captured*
traffic (pcap/pcapng files featurized to activation bits) under the same
contract; see ``docs/TRAFFIC.md``.

A scenario is a ``setup`` (draw the trace's persistent world: flow pool,
attacker signature, device fleet) plus an ``emit`` over an absolute packet
range.  :func:`stream` runs setup **once** and emits successive ranges, so a
chunked stream keeps its cross-packet structure — the same elephants recur,
burst phase follows global packet position, sensor walks continue — instead
of resetting per chunk.  All generators are pure numpy, deterministic per
``seed``, and produce ``(n, input_bits)`` int32 arrays in {0,1}.

The packet sequence is *defined* over fixed canonical emission chunks
(``CANONICAL_CHUNK`` packets): the randomness for the chunk starting at
absolute position ``p`` derives from ``(seed, p)`` alone, and the world is
seeded separately.  Any consumer chunking — ``generate``, ``stream`` at any
``chunk_size``, a stream paused and resumed mid-trace — re-slices the same
canonical sequence.  (Earlier revisions threaded one rng through every emit
call, which made the sequence depend on chunk boundaries whenever an emitter
issues several differently-shaped draws: resuming a stream mid-scenario
changed the packets.  The canonical-chunk scheme makes the advertised
invariance hold by construction.)

Invariants:

* **Determinism** — same ``(scenario, n, input_bits, seed)`` means the same
  bits, on any platform; ``stream`` over ``[0, n)`` in any chunking equals
  ``generate(n, ...)`` of the same world.  The BNN trainer's train/held-out
  splits (``train.bnn_trainer.make_traffic_task``) depend on this to carve
  temporal splits out of one world.
* **Shape/domain** — every emitter returns exactly ``(n, input_bits)``
  int32 in {0,1}; ``_fold_bits`` makes any scenario usable at any model
  input width (fold is parity-preserving per column).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator

import numpy as np

# Canonical 5-tuple layout: src ip (32) dst ip (32) ports (16+16) proto (8).
_TUPLE_BITS = 104

# The packet sequence is defined over emission chunks of this many packets;
# chunk ``p`` draws from ``default_rng([seed, _EMIT_TAG, p])``.  Part of the
# sequence definition: changing it changes every scenario's packets.
CANONICAL_CHUNK = 1024
_SETUP_TAG = 0
_EMIT_TAG = 1
_ASSIGN_TAG = 2


def _fold_bits(bits: np.ndarray, width: int) -> np.ndarray:
    """XOR-fold (n, k) bit rows to exactly ``width`` columns.

    Wider rows fold back onto themselves (hash-like, parity-preserving per
    column); narrower rows tile.  Keeps every scenario usable at any model
    input width.
    """
    n, k = bits.shape
    if n == 0:
        return np.zeros((0, width), np.int32)
    if k < width:
        reps = -(-width // k)
        bits = np.tile(bits, (1, reps))
        k = bits.shape[1]
    if k == width:
        return bits.astype(np.int32)
    pad = (-k) % width
    if pad:
        bits = np.concatenate([bits, np.zeros((n, pad), bits.dtype)], axis=1)
    # XOR-reduce == per-column parity of the sum for {0,1} entries, at a
    # fraction of the cost (this is the pcap featurizer's hot loop too).
    return np.bitwise_xor.reduce(
        bits.reshape(n, -1, width).astype(np.int32), axis=1
    )


def _int_bits(vals: np.ndarray, width: int) -> np.ndarray:
    """(n,) unsigned ints -> (n, width) little-endian bits."""
    # uint32 math is exact for the bits we keep (<= 32) and much faster.
    dtype = np.uint32 if width <= 32 else np.uint64
    shifts = np.arange(width, dtype=dtype)
    return ((vals[:, None].astype(dtype) >> shifts) & 1).astype(np.int32)


def _gray(vals: np.ndarray) -> np.ndarray:
    v = vals.astype(np.uint64)
    return v ^ (v >> 1)


@dataclasses.dataclass(frozen=True)
class Scenario:
    """``setup(rng, bits) -> state`` once per trace, then
    ``emit(state, rng, start, n, bits)`` over absolute packet positions
    ``[start, start + n)``.  ``state`` may be mutable (e.g. sensor walks).

    Emission happens in canonical ``CANONICAL_CHUNK``-packet chunks with a
    per-chunk rng derived from ``(seed, chunk position)`` — see the module
    docstring — so the sequence is identical under any consumer chunking.
    """

    name: str
    description: str
    _setup: Callable[[np.random.Generator, int], Any]
    _emit: Callable[[Any, np.random.Generator, int, int, int], np.ndarray]

    def iter_chunks(
        self, input_bits: int, seed: int = 0
    ) -> Iterator[np.ndarray]:
        """Infinite iterator over the canonical emission chunks of one world."""
        if input_bits <= 0:
            raise ValueError(f"input_bits must be positive, got {input_bits}")
        state = self._setup(
            np.random.default_rng([seed, _SETUP_TAG]), input_bits
        )
        start = 0
        while True:
            rng = np.random.default_rng([seed, _EMIT_TAG, start])
            out = self._emit(state, rng, start, CANONICAL_CHUNK, input_bits)
            assert (
                out.shape == (CANONICAL_CHUNK, input_bits)
                and out.dtype == np.int32
            )
            yield out
            start += CANONICAL_CHUNK

    def generate(self, n: int, input_bits: int, seed: int = 0) -> np.ndarray:
        """(n, input_bits) int32 {0,1} packet activation bits."""
        if n < 0 or input_bits <= 0:
            raise ValueError(f"bad trace shape n={n} input_bits={input_bits}")
        if n == 0:
            return np.zeros((0, input_bits), np.int32)
        chunks = []
        have = 0
        for c in self.iter_chunks(input_bits, seed):
            chunks.append(c)
            have += c.shape[0]
            if have >= n:
                break
        return np.concatenate(chunks, axis=0)[:n]

    def stream(
        self, n: int, input_bits: int, *, chunk_size: int, seed: int = 0
    ) -> Iterator[np.ndarray]:
        """Emit the same world (and exact packet sequence) as ``generate``,
        re-sliced into ``chunk_size``-packet chunks."""
        if chunk_size <= 0:
            raise ValueError(f"chunk_size must be positive, got {chunk_size}")
        src = _Puller(self.iter_chunks(input_bits, seed))
        for start in range(0, n, chunk_size):
            yield src.pull(min(chunk_size, n - start))


class _Puller:
    """Re-slice an infinite chunk iterator into pull-sized pieces."""

    def __init__(self, it: Iterator[np.ndarray]):
        self._it = it
        self._buf: list[np.ndarray] = []
        self._have = 0

    def pull(self, k: int) -> np.ndarray:
        while self._have < k:
            c = next(self._it)
            self._buf.append(c)
            self._have += c.shape[0]
        flat = (
            np.concatenate(self._buf, axis=0)
            if len(self._buf) > 1
            else self._buf[0]
        )
        out, rest = flat[:k], flat[k:]
        self._buf = [rest] if rest.shape[0] else []
        self._have = rest.shape[0]
        return out


# -- scenario implementations -----------------------------------------------

def _uniform_emit(state, rng, start, n, bits):
    return rng.integers(0, 2, (n, bits), dtype=np.int32)


def _flow_setup(rng, bits):
    n_flows = 256
    # Flow pool: random 5-tuples; popularity ~ 1/rank (elephants and mice).
    pool = _fold_bits(
        rng.integers(0, 2, (n_flows, _TUPLE_BITS), dtype=np.int32), bits
    )
    rank = np.arange(1, n_flows + 1, dtype=np.float64)
    p = (1.0 / rank) / (1.0 / rank).sum()
    return pool, p


def _flow_emit(state, rng, start, n, bits):
    pool, p = state
    return pool[rng.choice(pool.shape[0], size=n, p=p)]


def _ddos_setup(rng, bits):
    return rng.integers(0, 2, bits, dtype=np.int32)  # attacker signature


def _ddos_emit(state, rng, start, n, bits):
    period, burst_len = 1024, 256
    out = rng.integers(0, 2, (n, bits), dtype=np.int32)  # background
    pos = start + np.arange(n)  # burst phase follows *global* position
    in_burst = (pos % period) < burst_len
    jitter = rng.random((n, bits)) < 0.02  # per-bit flip prob inside a burst
    attack = np.where(jitter, 1 - state[None, :], state[None, :])
    out[in_burst] = attack[in_burst]
    return out


def _iot_setup(rng, bits):
    n_dev = 32
    return {"level": rng.integers(0, 1 << 16, n_dev)}  # walks continue


def _iot_emit(state, rng, start, n, bits):
    n_dev = state["level"].shape[0]
    dev = rng.integers(0, n_dev, n)
    steps = rng.integers(-3, 4, n)
    drift = np.zeros(n, np.int64)
    for d in range(n_dev):  # per-device cumulative walk from carried level
        sel = dev == d
        walk = state["level"][d] + np.cumsum(steps[sel])
        drift[sel] = walk
        if walk.size:
            state["level"][d] = walk[-1]
    reading = _gray(drift.astype(np.uint64) & 0xFFFF)
    header = np.concatenate(
        [_int_bits(dev.astype(np.uint64), 8), _int_bits(reading, 16)], axis=1
    )
    return _fold_bits(header, bits)


def _adv_setup(rng, bits):
    return rng.integers(0, 2, (8, bits), dtype=np.int32)  # prototypes


def _adv_emit(state, rng, start, n, bits):
    out = state[rng.integers(0, state.shape[0], n)].copy()
    k = max(1, bits // 16)  # flips per packet
    flips = rng.integers(0, bits, (n, k))
    rows = np.repeat(np.arange(n), k)
    np.add.at(out, (rows, flips.ravel()), 1)
    return (out % 2).astype(np.int32)


SCENARIOS: dict[str, Scenario] = {
    s.name: s
    for s in (
        Scenario(
            "uniform_random",
            "i.i.d. fair-coin bits",
            lambda rng, bits: None,
            _uniform_emit,
        ),
        Scenario(
            "flow_tuple",
            "heavy-tailed 5-tuple flow pool (flow classification)",
            _flow_setup,
            _flow_emit,
        ),
        Scenario(
            "ddos_burst",
            "background + periodic jittered attack bursts",
            _ddos_setup,
            _ddos_emit,
        ),
        Scenario(
            "iot_telemetry",
            "small device fleet, Gray-coded drifting sensor readings",
            _iot_setup,
            _iot_emit,
        ),
        Scenario(
            "adversarial_bitflip",
            "prototype headers with sparse random bit flips",
            _adv_setup,
            _adv_emit,
        ),
    )
}


def get_scenario(name: str) -> Scenario:
    try:
        return SCENARIOS[name]
    except KeyError:
        raise KeyError(
            f"unknown scenario {name!r}; have {sorted(SCENARIOS)}"
        ) from None


def register_scenario(scenario: Scenario, *, overwrite: bool = False) -> Scenario:
    """Add a scenario to :data:`SCENARIOS` (e.g. a pcap-backed one from
    ``dataplane.pcap``), making it usable everywhere a scenario name is —
    ``generate``/``stream``, trainer tasks, and mixed-tenant specs.
    Registering a different scenario under an existing name requires
    ``overwrite=True``; re-registering the same object is a no-op."""
    existing = SCENARIOS.get(scenario.name)
    if existing is not None and existing is not scenario and not overwrite:
        raise ValueError(
            f"scenario {scenario.name!r} is already registered; pass "
            "overwrite=True to replace it"
        )
    SCENARIOS[scenario.name] = scenario
    return scenario


def generate(name: str, n: int, input_bits: int, seed: int = 0) -> np.ndarray:
    return get_scenario(name).generate(n, input_bits, seed)


def stream(
    name: str, n: int, input_bits: int, *, chunk_size: int, seed: int = 0
) -> Iterator[np.ndarray]:
    """Yield a scenario as bounded chunks sharing one persistent world."""
    return get_scenario(name).stream(
        n, input_bits, chunk_size=chunk_size, seed=seed
    )


# -- mixed-tenant traffic -----------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TenantTrafficSpec:
    """One tenant's share of a mixed stream: which scenario generates its
    packets, how wide its model's input is, and its arrival weight."""

    scenario: str
    input_bits: int
    weight: float = 1.0

    def __post_init__(self) -> None:
        get_scenario(self.scenario)  # fail fast on unknown names
        if self.input_bits <= 0:
            raise ValueError(f"input_bits must be positive, got {self.input_bits}")
        if self.weight <= 0:
            raise ValueError(f"weight must be positive, got {self.weight}")


def tenant_stream_seed(seed: int, tid: int) -> int:
    """The derived seed of tenant ``tid``'s scenario sub-stream within a
    mixed trace.  Exposed so tests can reproduce one tenant's packets with
    plain :func:`generate` — tenant ``t``'s subsequence in a mixed stream IS
    ``generate(spec.scenario, count_t, spec.input_bits, seed=this)``."""
    return int(np.random.SeedSequence([seed, tid]).generate_state(1)[0])


def _assignment_chunks(
    n_tenants: int, weights: np.ndarray, seed: int
) -> Iterator[np.ndarray]:
    """Canonical-chunk iterator of weighted i.i.d. tenant-id draws."""
    start = 0
    while True:
        rng = np.random.default_rng([seed, _ASSIGN_TAG, start])
        yield rng.choice(n_tenants, size=CANONICAL_CHUNK, p=weights).astype(
            np.int32
        )
        start += CANONICAL_CHUNK


def mixed_tenant_stream(
    specs: list[TenantTrafficSpec] | tuple[TenantTrafficSpec, ...],
    n: int,
    *,
    chunk_size: int,
    seed: int = 0,
) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Interleave per-tenant scenario streams into one tagged packet stream.

    Yields ``(tenant_ids, bits)`` chunks: ``tenant_ids`` is ``(k,)`` int32,
    ``bits`` is ``(k, max(input_bits))`` int32 {0,1} with each row generated
    by its tenant's scenario at the tenant's width and zero-padded to the
    common width.  Arrival order is an i.i.d. weighted draw; each tenant's
    *subsequence* is exactly that tenant's scenario stream under the seed
    :func:`tenant_stream_seed` derives (setup once, per-tenant world
    persists across chunks, positions are tenant-local).

    Determinism matches :meth:`Scenario.stream`: same ``(specs, n, seed)``
    gives the same packets under any chunking — assignment and every
    tenant's emission ride the canonical-chunk scheme, and each tenant's
    packet positions depend only on cumulative assignment counts.
    """
    if not specs:
        raise ValueError("mixed_tenant_stream needs at least one tenant spec")
    if chunk_size <= 0:
        raise ValueError(f"chunk_size must be positive, got {chunk_size}")
    width = max(s.input_bits for s in specs)
    weights = np.array([s.weight for s in specs], np.float64)
    weights = weights / weights.sum()

    assign = _Puller(_assignment_chunks(len(specs), weights, seed))
    pullers = [
        _Puller(
            get_scenario(sp.scenario).iter_chunks(
                sp.input_bits, seed=tenant_stream_seed(seed, t)
            )
        )
        for t, sp in enumerate(specs)
    ]

    for start in range(0, n, chunk_size):
        k = min(chunk_size, n - start)
        tids = assign.pull(k)
        bits = np.zeros((k, width), np.int32)
        for t, sp in enumerate(specs):
            rows = np.nonzero(tids == t)[0]
            if rows.size:
                bits[rows, : sp.input_bits] = pullers[t].pull(rows.size)
        yield tids, bits


def mixed_tenant_generate(
    specs: list[TenantTrafficSpec] | tuple[TenantTrafficSpec, ...],
    n: int,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """One-shot form of :func:`mixed_tenant_stream`: ``(tenant_ids, bits)``
    for the whole trace."""
    chunks = list(mixed_tenant_stream(specs, n, chunk_size=max(1, n), seed=seed))
    if not chunks:
        width = max(s.input_bits for s in specs)
        return np.zeros(0, np.int32), np.zeros((0, width), np.int32)
    return (
        np.concatenate([t for t, _ in chunks]),
        np.concatenate([b for _, b in chunks]),
    )
