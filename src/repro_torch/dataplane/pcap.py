"""Pcap ingestion: capture files -> activation-bit traces.

N2Net's premise is that the model input "is encoded in the network packets'
header" — this module is where *real* packets enter the reproduction.  It
reads classic pcap and pcapng capture files with zero dependencies beyond
numpy (no scapy, no libpcap, no network access), slices the Ethernet/IPv4/
TCP/UDP header fields of every packet into the same fixed-width
activation-bit matrices the synthetic ``traffic`` scenarios emit, and writes
deterministic synthetic captures so tests/CI round-trip real file bytes
without shipping binary fixtures.  See ``docs/TRAFFIC.md`` for the full
bit-encoding tables and usage guide.

The pieces, in pipeline order:

* :func:`read_pcap` — parse capture bytes (or a file path) into a
  :class:`Capture`: a padded ``(n, max_len)`` uint8 packet matrix plus
  per-packet lengths and float64 timestamps.  Classic pcap is supported in
  all four magic variants (micro/nanosecond x little/big endian); pcapng
  supports SHB/IDB/EPB/SPB blocks, both byte orders, and per-interface
  ``if_tsresol``.  Malformed or truncated input raises
  :class:`PcapFormatError` — never silently drops tail packets.
* :func:`parse_headers` / :func:`featurize` — the hot path: fully
  vectorized header slicing (no per-packet Python loop) from the packet
  matrix into ``FEATURE_LAYOUT`` fields — addresses, ports, protocol,
  length, TCP flags, and log-bucketed inter-arrival times — then into a
  ``(n, PCAP_FEATURE_BITS)`` {0,1} int32 matrix, XOR-foldable to any model
  input width exactly like every synthetic scenario.
* :func:`write_pcap` / :func:`write_pcapng` — byte-exact writers for both
  formats; :func:`synthesize_capture` emits a deterministic labeled
  two-class trace (IoT-style UDP telemetry vs TCP SYN flood) whose write ->
  read -> featurize round trip is the test/CI substrate.
* :func:`pcap_scenario` / :func:`register_pcap_scenario` — wrap a capture
  as a ``traffic.Scenario`` (cyclic replay) and register it in
  ``traffic.SCENARIOS``, which makes captures first-class everywhere
  scenarios already are: ``traffic.generate``/``stream``, the BNN trainer's
  task builder, and pcap-backed tenants in ``traffic.mixed_tenant_stream``.
* :func:`label_packets` — the labeling hook: apply a rule over parsed
  header fields to get per-packet int labels, feeding
  ``train.bnn_trainer.make_capture_task``'s temporal splits.

Invariants:

* **Determinism** — same capture bytes mean the same :class:`Capture`, the
  same features, and the same scenario packets on any platform; writers are
  deterministic functions of ``(packets, timestamps)``, and
  :func:`synthesize_capture` of ``(n, seed)`` alone.
* **Round trip** — ``read_pcap(write_pcap(pkts, ts))`` reproduces every
  packet byte-exactly and every timestamp to the written resolution; same
  for pcapng.
* **Scenario contract** — a registered pcap scenario obeys the
  canonical-chunk contract of ``traffic``: ``stream`` at any chunking (or
  paused and resumed mid-trace) replays exactly ``generate``'s packets.
  Replay is cyclic over the capture and *seed-independent* — the capture
  is the world.
* **Shape/domain** — :func:`featurize` returns ``(n, width)`` int32 in
  {0,1} for any requested width; fields absent from a packet (non-IPv4,
  non-TCP/UDP, truncated headers) contribute zero bits, never garbage.
"""
from __future__ import annotations

import dataclasses
import os
import struct
import time
from typing import Callable, Sequence

import numpy as np

from repro_torch import obs
from repro_torch.dataplane import traffic

__all__ = [
    "Capture",
    "FEATURE_LAYOUT",
    "HeaderFields",
    "LINKTYPE_ETHERNET",
    "PCAP_FEATURE_BITS",
    "PcapFormatError",
    "featurize",
    "label_packets",
    "parse_headers",
    "pcap_scenario",
    "read_pcap",
    "register_pcap_scenario",
    "synthesize_capture",
    "write_pcap",
    "write_pcapng",
]

LINKTYPE_ETHERNET = 1

# Classic pcap magics, keyed by their little-endian read: value -> (endian
# of the whole file, timestamp fraction unit in seconds).
_PCAP_MAGIC_US = 0xA1B2C3D4
_PCAP_MAGIC_NS = 0xA1B23C4D
_CLASSIC_MAGICS = {
    _PCAP_MAGIC_US: ("<", 1e-6),
    _PCAP_MAGIC_NS: ("<", 1e-9),
    0xD4C3B2A1: (">", 1e-6),
    0x4D3CB2A1: (">", 1e-9),
}

# pcapng block types / byte-order magic.
_NG_SHB = 0x0A0D0D0A   # section header (palindromic: endian-independent)
_NG_IDB = 0x00000001   # interface description
_NG_SPB = 0x00000003   # simple packet
_NG_EPB = 0x00000006   # enhanced packet
_NG_BOM = 0x1A2B3C4D
_NG_SNAPLEN = 65535


class PcapFormatError(ValueError):
    """Capture bytes are not a well-formed pcap/pcapng file."""


# ---------------------------------------------------------------------------
# Capture container
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Capture:
    """A parsed capture: padded packet bytes + lengths + timestamps.

    ``data`` is ``(n, max_len)`` uint8, zero-padded past each packet's
    ``lengths[i]``; ``timestamps`` are float64 seconds (absolute, in capture
    order).  The padded-matrix layout is what makes :func:`parse_headers`
    one vectorized pass instead of a per-packet loop.

    float64 seconds resolve ~0.24 us at epoch scale (2**-22 s near 2**31),
    so nanosecond-resolution captures with absolute epoch timestamps
    quantize to that granularity on read; timestamps near 0 keep full
    precision.  IAT features bucket at >= 1 us boundaries, so this only
    matters to consumers doing their own sub-microsecond timing.
    """

    data: np.ndarray
    lengths: np.ndarray
    timestamps: np.ndarray
    linktype: int = LINKTYPE_ETHERNET
    fmt: str = "pcap"

    def __post_init__(self):
        n = self.lengths.shape[0]
        if self.data.shape[0] != n or self.timestamps.shape[0] != n:
            raise ValueError(
                f"inconsistent capture: {self.data.shape[0]} packet rows, "
                f"{n} lengths, {self.timestamps.shape[0]} timestamps"
            )

    @property
    def num_packets(self) -> int:
        return int(self.lengths.shape[0])

    def packet(self, i: int) -> bytes:
        """Packet ``i``'s exact captured bytes (padding stripped)."""
        return self.data[i, : int(self.lengths[i])].tobytes()

    def packets(self) -> list[bytes]:
        return [self.packet(i) for i in range(self.num_packets)]


def _pack_capture(
    pkts: list[bytes], ts: list[float], linktype: int, fmt: str
) -> Capture:
    n = len(pkts)
    max_len = max((len(p) for p in pkts), default=0)
    data = np.zeros((n, max_len), np.uint8)
    lengths = np.zeros(n, np.int32)
    for i, p in enumerate(pkts):
        lengths[i] = len(p)
        data[i, : len(p)] = np.frombuffer(p, np.uint8)
    return Capture(
        data=data,
        lengths=lengths,
        timestamps=np.asarray(ts, np.float64),
        linktype=linktype,
        fmt=fmt,
    )


# ---------------------------------------------------------------------------
# Readers
# ---------------------------------------------------------------------------

def _as_bytes(source) -> bytes:
    if isinstance(source, (bytes, bytearray, memoryview)):
        return bytes(source)
    if isinstance(source, (str, os.PathLike)):
        with open(source, "rb") as fh:
            return fh.read()
    raise TypeError(
        f"read_pcap wants bytes or a file path, got {type(source).__name__}"
    )


def read_pcap(source) -> Capture:
    """Parse a capture file (path or raw bytes), sniffing the format.

    Dispatches on the first 4 bytes: any classic-pcap magic (micro/nano,
    either endian) or a pcapng section header.  Raises
    :class:`PcapFormatError` on unknown magic, truncation, or structural
    corruption.
    """
    raw = _as_bytes(source)
    if len(raw) < 4:
        raise PcapFormatError(
            f"capture is {len(raw)} bytes — shorter than any magic number"
        )
    magic = struct.unpack_from("<I", raw, 0)[0]
    if magic == _NG_SHB:
        return _read_pcapng(raw)
    if magic in _CLASSIC_MAGICS:
        return _read_classic(raw)
    raise PcapFormatError(f"unknown capture magic 0x{magic:08X}")


def _read_classic(raw: bytes) -> Capture:
    endian, frac = _CLASSIC_MAGICS[struct.unpack_from("<I", raw, 0)[0]]
    if len(raw) < 24:
        raise PcapFormatError(
            f"classic pcap global header truncated ({len(raw)} < 24 bytes)"
        )
    _, _, _, _, _, _, network = struct.unpack_from(endian + "IHHiIII", raw, 0)
    pkts: list[bytes] = []
    ts: list[float] = []
    off = 24
    while off < len(raw):
        if len(raw) - off < 16:
            raise PcapFormatError(
                f"record header truncated at byte {off} "
                f"({len(raw) - off} of 16 bytes)"
            )
        sec, tfrac, incl, _orig = struct.unpack_from(endian + "IIII", raw, off)
        off += 16
        if len(raw) - off < incl:
            raise PcapFormatError(
                f"record {len(pkts)} data truncated at byte {off} "
                f"({len(raw) - off} of {incl} bytes)"
            )
        pkts.append(raw[off : off + incl])
        ts.append(sec + tfrac * frac)
        off += incl
    return _pack_capture(pkts, ts, int(network), "pcap")


def _ng_tsresol(options: bytes, endian: str) -> float:
    """Seconds per timestamp unit from an IDB option block (default 1e-6)."""
    off = 0
    while off + 4 <= len(options):
        code, olen = struct.unpack_from(endian + "HH", options, off)
        off += 4
        if code == 0:  # opt_endofopt
            break
        if off + olen > len(options):
            raise PcapFormatError(
                f"interface option {code} claims {olen} value bytes; only "
                f"{len(options) - off} remain in the block"
            )
        val = options[off : off + olen]
        off += olen + ((-olen) % 4)
        if code == 9 and olen == 1:  # if_tsresol
            v = val[0]
            return 2.0 ** -(v & 0x7F) if v & 0x80 else 10.0 ** -v
    return 1e-6


def _read_pcapng(raw: bytes) -> Capture:
    endian: str | None = None
    # (linktype, snaplen, res); snaplen 0 means unlimited.  Interface ids
    # are section-scoped, so a new SHB resets the list.
    interfaces: list[tuple[int, int, float]] = []
    linktype: int | None = None
    pkts: list[bytes] = []
    ts: list[float] = []
    off = 0
    while off < len(raw):
        if len(raw) - off < 12:
            raise PcapFormatError(
                f"pcapng block header truncated at byte {off}"
            )
        if struct.unpack_from("<I", raw, off)[0] == _NG_SHB:
            bom = struct.unpack_from("<I", raw, off + 8)[0]
            if bom == _NG_BOM:
                endian = "<"
            elif bom == struct.unpack(">I", struct.pack("<I", _NG_BOM))[0]:
                endian = ">"
            else:
                raise PcapFormatError(
                    f"pcapng byte-order magic 0x{bom:08X} at byte {off + 8} "
                    "is neither endianness"
                )
            interfaces = []  # new section: interface ids start over
        if endian is None:
            raise PcapFormatError("pcapng file does not start with a "
                                  "section header block")
        btype, blen = struct.unpack_from(endian + "II", raw, off)
        if blen < 12 or blen % 4:
            raise PcapFormatError(
                f"pcapng block at byte {off} has bad length {blen}"
            )
        if len(raw) - off < blen:
            raise PcapFormatError(
                f"pcapng block at byte {off} truncated "
                f"({len(raw) - off} of {blen} bytes)"
            )
        trailer = struct.unpack_from(endian + "I", raw, off + blen - 4)[0]
        if trailer != blen:
            raise PcapFormatError(
                f"pcapng block at byte {off}: trailing length {trailer} != "
                f"leading length {blen}"
            )
        body = raw[off + 8 : off + blen - 4]
        if btype == _NG_IDB:
            if len(body) < 8:
                raise PcapFormatError("interface description block too short")
            lt, _, snaplen = struct.unpack_from(endian + "HHI", body, 0)
            interfaces.append(
                (int(lt), snaplen, _ng_tsresol(body[8:], endian))
            )
        elif btype == _NG_EPB:
            if not interfaces:
                raise PcapFormatError(
                    "enhanced packet block before any interface description"
                )
            if len(body) < 20:
                raise PcapFormatError("enhanced packet block too short")
            iface, th, tl, cap, _orig = struct.unpack_from(
                endian + "IIIII", body, 0
            )
            if iface >= len(interfaces):
                raise PcapFormatError(
                    f"enhanced packet block names interface {iface}; only "
                    f"{len(interfaces)} declared"
                )
            if len(body) - 20 < cap:
                raise PcapFormatError(
                    f"packet {len(pkts)} data truncated "
                    f"({len(body) - 20} of {cap} bytes)"
                )
            linktype = _check_packet_linktype(
                linktype, interfaces[iface][0], len(pkts)
            )
            pkts.append(body[20 : 20 + cap])
            ts.append(((th << 32) | tl) * interfaces[iface][2])
        elif btype == _NG_SPB:
            if not interfaces:
                raise PcapFormatError(
                    "simple packet block before any interface description"
                )
            if len(body) < 4:
                raise PcapFormatError("simple packet block too short")
            orig = struct.unpack_from(endian + "I", body, 0)[0]
            snap = interfaces[0][1]
            cap = orig if snap == 0 else min(orig, snap)  # 0 = no limit
            if len(body) - 4 < cap:
                raise PcapFormatError(
                    f"packet {len(pkts)} data truncated "
                    f"({len(body) - 4} of {cap} bytes)"
                )
            linktype = _check_packet_linktype(
                linktype, interfaces[0][0], len(pkts)
            )
            pkts.append(body[4 : 4 + cap])
            ts.append(0.0)  # SPBs carry no timestamp
        # all other block types (NRB, ISB, custom) are skipped whole
        off += blen
    if linktype is None:  # no packets: fall back to the declared interface
        linktype = interfaces[0][0] if interfaces else LINKTYPE_ETHERNET
    return _pack_capture(pkts, ts, linktype, "pcapng")


def _check_packet_linktype(
    seen: int | None, lt: int, packet_index: int
) -> int:
    """One capture, one link type: a ``Capture`` carries a single
    ``linktype``, so packets from interfaces with mixed link types would be
    mis-featurized (e.g. raw-IP bytes sliced at Ethernet offsets) — refuse
    loudly instead."""
    if seen is not None and lt != seen:
        raise PcapFormatError(
            f"packet {packet_index} arrives on a linktype-{lt} interface "
            f"but earlier packets used linktype {seen}; mixed link types "
            "in one capture are not supported"
        )
    return lt


# ---------------------------------------------------------------------------
# Writers
# ---------------------------------------------------------------------------

def _snaplen_for(packets: Sequence[bytes]) -> int:
    """Declared snap length: nothing we serialize whole may exceed it
    (caplen > snaplen reads as corruption to libpcap-based tools)."""
    return max(_NG_SNAPLEN, max((len(p) for p in packets), default=0))


def _check_write_args(packets, timestamps) -> np.ndarray:
    ts = np.asarray(timestamps, np.float64)
    if ts.ndim != 1 or ts.shape[0] != len(packets):
        raise ValueError(
            f"{len(packets)} packets but timestamp shape {ts.shape}"
        )
    if ts.size and (ts < 0).any():
        raise ValueError("timestamps must be non-negative seconds")
    return ts


def write_pcap(
    packets: Sequence[bytes],
    timestamps,
    *,
    path: str | os.PathLike | None = None,
    nanosecond: bool = False,
    endian: str = "<",
) -> bytes:
    """Serialize packets to a classic pcap file; returns the bytes.

    ``timestamps`` are float seconds, stored at micro- (default) or
    nanosecond resolution; ``endian`` picks the file byte order (both are
    valid classic pcap and :func:`read_pcap` accepts either).  Writes to
    ``path`` as well when given.
    """
    if endian not in ("<", ">"):
        raise ValueError(f"endian must be '<' or '>', got {endian!r}")
    ts = _check_write_args(packets, timestamps)
    magic = _PCAP_MAGIC_NS if nanosecond else _PCAP_MAGIC_US
    unit = 1e9 if nanosecond else 1e6
    out = bytearray(
        struct.pack(
            endian + "IHHiIII", magic, 2, 4, 0, 0, _snaplen_for(packets),
            LINKTYPE_ETHERNET,
        )
    )
    for pkt, t in zip(packets, ts):
        # Split before scaling: (t - sec) is exact in float64, so epoch-scale
        # times keep their full sub-second precision (t * unit would not).
        sec = int(t)
        frac = int(round((t - sec) * unit))
        if frac >= int(unit):  # rounding carried into the next second
            sec, frac = sec + 1, 0
        out += struct.pack(endian + "IIII", sec, frac, len(pkt), len(pkt))
        out += pkt
    raw = bytes(out)
    if path is not None:
        with open(path, "wb") as fh:
            fh.write(raw)
    return raw


def write_pcapng(
    packets: Sequence[bytes],
    timestamps,
    *,
    path: str | os.PathLike | None = None,
    endian: str = "<",
) -> bytes:
    """Serialize packets to a pcapng file (SHB + one IDB + EPBs).

    Timestamps are stored at the pcapng default microsecond resolution.
    """
    if endian not in ("<", ">"):
        raise ValueError(f"endian must be '<' or '>', got {endian!r}")
    ts = _check_write_args(packets, timestamps)
    out = bytearray(
        struct.pack(
            endian + "IIIHHqI", _NG_SHB, 28, _NG_BOM, 1, 0, -1, 28
        )
    )
    out += struct.pack(
        endian + "IIHHII", _NG_IDB, 20, LINKTYPE_ETHERNET, 0,
        _snaplen_for(packets), 20,
    )
    for pkt, t in zip(packets, ts):
        ts64 = int(round(t * 1e6))
        pad = (-len(pkt)) % 4
        blen = 32 + len(pkt) + pad
        out += struct.pack(
            endian + "IIIIIII", _NG_EPB, blen, 0, (ts64 >> 32) & 0xFFFFFFFF,
            ts64 & 0xFFFFFFFF, len(pkt), len(pkt),
        )
        out += pkt
        out += b"\x00" * pad
        out += struct.pack(endian + "I", blen)
    raw = bytes(out)
    if path is not None:
        with open(path, "wb") as fh:
            fh.write(raw)
    return raw


# ---------------------------------------------------------------------------
# Header featurizer (the hot path — fully vectorized)
# ---------------------------------------------------------------------------

# Activation-bit layout: field order and width.  Integer fields encode
# little-endian (bit k of the value is column k of the field, matching
# ``traffic._int_bits``); ``iat_bucket`` is a one-hot over 8 log4-spaced
# inter-arrival buckets.  Documented bit-for-bit in docs/TRAFFIC.md.
FEATURE_LAYOUT = (
    ("src_ip", 32),
    ("dst_ip", 32),
    ("src_port", 16),
    ("dst_port", 16),
    ("proto", 8),
    ("ip_len", 16),
    ("tcp_flags", 8),
    ("iat_bucket", 8),
)
PCAP_FEATURE_BITS = sum(width for _, width in FEATURE_LAYOUT)  # 136

_ETHERTYPE_IPV4 = 0x0800
_ETHERTYPE_VLAN = 0x8100


@dataclasses.dataclass(frozen=True)
class HeaderFields:
    """Per-packet parsed header columns (all ``(n,)`` numpy arrays).

    Validity is explicit: ``src_ip``..``ip_len`` are zero wherever
    ``is_ipv4`` is false, ports wherever the packet is neither TCP nor UDP
    (or too short), ``tcp_flags`` wherever ``is_tcp`` is false.
    ``iat_bucket`` is ``clip(floor(log4(1 + iat_us)), 0, 7)`` — log-spaced
    inter-arrival buckets; the first packet's IAT is 0.
    """

    is_ipv4: np.ndarray
    is_tcp: np.ndarray
    is_udp: np.ndarray
    src_ip: np.ndarray
    dst_ip: np.ndarray
    src_port: np.ndarray
    dst_port: np.ndarray
    proto: np.ndarray
    ip_len: np.ndarray
    tcp_flags: np.ndarray
    iat_bucket: np.ndarray


def _iat_buckets(timestamps: np.ndarray) -> np.ndarray:
    iat_us = np.diff(timestamps, prepend=timestamps[:1]) * 1e6
    iat_us = np.maximum(iat_us, 0.0)
    return np.clip(
        (np.log2(iat_us + 1.0) * 0.5).astype(np.int64), 0, 7
    ).astype(np.int32)


def parse_headers(cap: Capture) -> HeaderFields:
    """Vectorized Ethernet/IPv4/TCP/UDP header slicing over a capture.

    One pass of numpy gathers over the padded packet matrix — no per-packet
    Python loop.  Handles untagged Ethernet II and one 802.1Q VLAN tag;
    anything else (non-IPv4 L3, IPv6, truncated headers) yields zeroed
    fields with the validity masks false.
    """
    n = cap.num_packets
    if n == 0:
        z = np.zeros(0, np.uint32)
        zb = np.zeros(0, bool)
        return HeaderFields(zb, zb, zb, z, z, z, z, z, z, z,
                            np.zeros(0, np.int32))
    if cap.linktype != LINKTYPE_ETHERNET:
        raise PcapFormatError(
            f"featurizer supports LINKTYPE_ETHERNET (1); capture is "
            f"linktype {cap.linktype}"
        )
    data = cap.data
    lengths = cap.lengths.astype(np.int64)
    rows = np.arange(n)
    width = data.shape[1]

    def at(off):
        """Byte at per-packet offset ``off``; 0 past the captured length."""
        off = np.asarray(off, np.int64)
        if off.ndim == 0:
            off = np.full(n, off)
        idx = np.minimum(off, width - 1) if width else np.zeros(n, np.int64)
        val = data[rows, idx].astype(np.uint32) if width else np.zeros(
            n, np.uint32
        )
        return np.where(off < lengths, val, 0).astype(np.uint32)

    def be16(off):
        return (at(off) << 8) | at(np.asarray(off, np.int64) + 1)

    def be32(off):
        return (be16(off) << 16) | be16(np.asarray(off, np.int64) + 2)

    eth_type = be16(12)
    vlan = eth_type == _ETHERTYPE_VLAN
    l3 = np.where(vlan, 18, 14).astype(np.int64)
    eth_type = np.where(vlan, be16(16), eth_type)

    vihl = at(l3)
    version = vihl >> 4
    ihl = (vihl & 0xF).astype(np.int64)
    is_ipv4 = (
        (eth_type == _ETHERTYPE_IPV4)
        & (version == 4)
        & (ihl >= 5)
        & (lengths >= l3 + 4 * ihl)
    )
    l4 = l3 + 4 * ihl

    proto = np.where(is_ipv4, at(l3 + 9), 0)
    has_ports = (
        is_ipv4 & np.isin(proto, (6, 17)) & (lengths >= l4 + 4)
    )
    is_tcp = is_ipv4 & (proto == 6) & (lengths >= l4 + 14)
    is_udp = has_ports & (proto == 17)

    return HeaderFields(
        is_ipv4=is_ipv4,
        is_tcp=is_tcp,
        is_udp=is_udp,
        src_ip=np.where(is_ipv4, be32(l3 + 12), 0).astype(np.uint32),
        dst_ip=np.where(is_ipv4, be32(l3 + 16), 0).astype(np.uint32),
        src_port=np.where(has_ports, be16(l4), 0).astype(np.uint32),
        dst_port=np.where(has_ports, be16(l4 + 2), 0).astype(np.uint32),
        proto=proto.astype(np.uint32),
        ip_len=np.where(is_ipv4, be16(l3 + 2), 0).astype(np.uint32),
        tcp_flags=np.where(is_tcp, at(l4 + 13), 0).astype(np.uint32),
        iat_bucket=_iat_buckets(cap.timestamps),
    )


def featurize(cap: Capture, input_bits: int | None = None) -> np.ndarray:
    """Capture -> ``(n, width)`` {0,1} int32 activation-bit matrix.

    With ``input_bits=None`` the full ``PCAP_FEATURE_BITS``-column layout
    (``FEATURE_LAYOUT``) is returned; otherwise it is XOR-folded/tiled to
    exactly ``input_bits`` columns with the same ``traffic._fold_bits``
    transform every synthetic scenario uses.

    Instrumented through ``repro.obs`` (featurized-packet counter, per-call
    latency histogram, throughput gauge) — no-ops unless the global
    observability switch is on.
    """
    if obs.enabled():
        with obs.span(
            "execute:pcap_featurize", cat="execute", packets=cap.num_packets
        ):
            t0 = time.perf_counter()
            out = _featurize(cap, input_bits)
            dt = time.perf_counter() - t0
        m = obs.registry()
        m.counter("pcap.packets_featurized_total").inc(cap.num_packets)
        m.histogram("pcap.featurize_seconds").observe(dt)
        if dt > 0:
            m.gauge("pcap.featurize_pps").set(cap.num_packets / dt)
        return out
    return _featurize(cap, input_bits)


def _featurize(cap: Capture, input_bits: int | None = None) -> np.ndarray:
    f = parse_headers(cap)
    n = cap.num_packets
    if n == 0:
        bits = np.zeros((0, PCAP_FEATURE_BITS), np.int32)
    else:
        cols = {
            "src_ip": f.src_ip, "dst_ip": f.dst_ip,
            "src_port": f.src_port, "dst_port": f.dst_port,
            "proto": f.proto, "ip_len": f.ip_len, "tcp_flags": f.tcp_flags,
        }
        parts = []
        for name, fw in FEATURE_LAYOUT:
            if name == "iat_bucket":
                parts.append(
                    (f.iat_bucket[:, None] == np.arange(fw)).astype(np.int32)
                )
            else:
                parts.append(traffic._int_bits(cols[name], fw))
        bits = np.concatenate(parts, axis=1)
    if input_bits is None:
        return bits
    if input_bits <= 0:
        raise ValueError(f"input_bits must be positive, got {input_bits}")
    return traffic._fold_bits(bits, input_bits)


def label_packets(
    cap: Capture,
    rule: Callable[[HeaderFields], np.ndarray],
    *,
    fields: HeaderFields | None = None,
) -> np.ndarray:
    """Apply a labeling rule over parsed header fields.

    ``rule`` sees the capture's :class:`HeaderFields` and returns ``(n,)``
    integer labels — e.g. ``lambda f: (f.proto == 6).astype(int)`` labels
    TCP packets 1.  This is the hook that turns a raw capture into a
    supervised task for ``train.bnn_trainer.make_capture_task``.  Pass
    ``fields`` to reuse an existing :func:`parse_headers` result instead of
    re-parsing the capture.
    """
    labels = np.asarray(rule(fields if fields is not None else parse_headers(cap)))
    if labels.shape != (cap.num_packets,):
        raise ValueError(
            f"labeling rule returned shape {labels.shape} for "
            f"{cap.num_packets} packets"
        )
    return labels.astype(np.int32)


# ---------------------------------------------------------------------------
# Scenario integration
# ---------------------------------------------------------------------------

def pcap_scenario(
    source,
    *,
    name: str,
    description: str | None = None,
    features: np.ndarray | None = None,
) -> traffic.Scenario:
    """Wrap a capture (path, bytes, or :class:`Capture`) as a Scenario.

    The capture is featurized once; emission replays its feature rows
    cyclically by absolute packet position, so the scenario meets the
    canonical-chunk contract by construction (same packets under any
    chunking, pause, or resume) and ignores the stream seed — the capture
    is the world.  Pass ``features`` (a full-width :func:`featurize`
    result) to reuse work the caller already did instead of re-featurizing.
    """
    cap = source if isinstance(source, Capture) else read_pcap(source)
    if features is None:
        feats = featurize(cap)
    else:
        feats = np.asarray(features, np.int32)
        if feats.shape != (cap.num_packets, PCAP_FEATURE_BITS):
            raise ValueError(
                f"features must be ({cap.num_packets}, {PCAP_FEATURE_BITS}) "
                f"full-width featurize output, got {feats.shape}"
            )
    if feats.shape[0] == 0:
        raise PcapFormatError(
            f"cannot build scenario {name!r} from an empty capture"
        )

    def _setup(rng, bits):
        return traffic._fold_bits(feats, bits)

    def _emit(state, rng, start, n, bits):
        return state[(start + np.arange(n)) % state.shape[0]]

    return traffic.Scenario(
        name,
        description
        or f"pcap replay ({feats.shape[0]} packets, {cap.fmt})",
        _setup,
        _emit,
    )


def register_pcap_scenario(
    name: str,
    source,
    *,
    description: str | None = None,
    features: np.ndarray | None = None,
    overwrite: bool = False,
) -> traffic.Scenario:
    """Build a pcap scenario and register it in ``traffic.SCENARIOS``.

    Once registered, the capture is usable everywhere a scenario name is:
    ``traffic.generate``/``stream``, ``make_traffic_task``, and pcap-backed
    tenants in ``traffic.mixed_tenant_stream``.
    """
    return traffic.register_scenario(
        pcap_scenario(
            source, name=name, description=description, features=features
        ),
        overwrite=overwrite,
    )


# ---------------------------------------------------------------------------
# Deterministic synthetic captures (the test/CI substrate)
# ---------------------------------------------------------------------------

def synthesize_capture(
    n: int, seed: int = 0, *, flood_frac: float = 0.35
) -> tuple[list[bytes], np.ndarray, np.ndarray]:
    """A deterministic labeled two-class packet trace, as raw bytes.

    Class 0 (weight ``1 - flood_frac``) is IoT-style telemetry: a 32-device
    fleet sends UDP/5683 readings to a gateway at millisecond inter-arrival
    times.  Class 1 is a TCP SYN flood: spoofed random source addresses
    hammer one victim ``:80`` at microsecond IATs.  Returns ``(packets,
    timestamps, labels)`` ready for :func:`write_pcap` /
    :func:`write_pcapng`; everything derives from ``(n, seed)`` alone, so
    tests and CI can round-trip real capture *files* without shipping
    binary fixtures.
    """
    if n < 0:
        raise ValueError(f"packet count must be >= 0, got {n}")
    rng = np.random.default_rng([seed, 0x9CA9])
    labels = (rng.random(n) < flood_frac).astype(np.int32)
    flood = labels == 1

    def store8(d, col, vals):
        d[:, col] = np.asarray(vals, np.uint64) & 0xFF

    def store16(d, col, vals):
        v = np.asarray(vals, np.uint64)
        d[:, col] = (v >> 8) & 0xFF
        d[:, col + 1] = v & 0xFF

    def store32(d, col, vals):
        v = np.asarray(vals, np.uint64)
        store16(d, col, v >> 16)
        store16(d, col + 2, v & 0xFFFF)

    def eth_ip_common(d, total_len, ttl, proto, src_ip, dst_ip, df):
        d[:, 0:6] = (2, 0, 0, 0, 0, 1)        # gateway/victim MAC
        d[:, 6:12] = (2, 0, 0, 0, 0, 2)
        store16(d, 12, np.full(n, _ETHERTYPE_IPV4))
        store8(d, 14, np.full(n, 0x45))        # IPv4, IHL 5
        store16(d, 16, total_len)
        store16(d, 18, np.arange(n) & 0xFFFF)  # IP id
        store16(d, 20, np.full(n, 0x4000 if df else 0))
        store8(d, 22, ttl)
        store8(d, 23, proto)
        store32(d, 26, src_ip)
        store32(d, 30, dst_ip)

    # Telemetry template: Eth(14) + IPv4(20) + UDP(8) + 8B reading = 50.
    dev = rng.integers(0, 32, n)
    tele = np.zeros((n, 54), np.uint8)
    eth_ip_common(
        tele, np.full(n, 36), np.full(n, 64), np.full(n, 17),
        0x0A000100 + dev, np.full(n, 0x0A000001), df=True,
    )
    store16(tele, 34, 30000 + dev)             # src port per device
    store16(tele, 36, np.full(n, 5683))        # CoAP
    store16(tele, 38, np.full(n, 16))          # UDP length
    tele[:, 42:50] = rng.integers(0, 256, (n, 8))

    # Flood template: Eth(14) + IPv4(20) + TCP(20) = 54, SYN to victim:80.
    fl = np.zeros((n, 54), np.uint8)
    eth_ip_common(
        fl, np.full(n, 40), rng.integers(32, 129, n), np.full(n, 6),
        rng.integers(0, 1 << 32, n, dtype=np.uint64),
        np.full(n, 0xC0A80164), df=False,
    )
    store16(fl, 34, rng.integers(1024, 65536, n))
    store16(fl, 36, np.full(n, 80))
    store32(fl, 38, rng.integers(0, 1 << 32, n, dtype=np.uint64))  # seq
    store8(fl, 46, np.full(n, 0x50))           # data offset 5
    store8(fl, 47, np.full(n, 0x02))           # SYN
    store16(fl, 48, np.full(n, 1024))          # window

    data = np.where(flood[:, None], fl, tele)
    lengths = np.where(flood, 54, 50)
    iat_us = np.where(flood, rng.integers(1, 8, n), rng.integers(200, 5000, n))
    timestamps = np.cumsum(iat_us).astype(np.float64) * 1e-6
    packets = [data[i, : lengths[i]].tobytes() for i in range(n)]
    return packets, timestamps, labels
