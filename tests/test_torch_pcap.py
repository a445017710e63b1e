"""Port pcap ingestion: ``repro_torch.dataplane.pcap`` (a copy of the
reference's numpy-only module) and the scenario registry it feeds, against
the reference's, on the CPU.

Bytes, arrays and header fields are compared exactly: both writers must
emit the reference's bytes, both readers must read the reference's bytes to
the same capture, and a registered capture scenario must replay the same
packets in both packages' traffic registries.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from repro_torch.dataplane import pcap as tpcap
from repro_torch.dataplane import traffic as ttr

from repro.dataplane import pcap as jpcap
from repro.dataplane import traffic as jtr

N = 300


@pytest.fixture(scope="module")
def capture():
    """One synthetic capture from each package (they must agree) and the
    reference's bytes of it in every writer variant."""
    pkts, ts, labels = jpcap.synthesize_capture(N, seed=3)
    raws = {
        ("pcap", endian, ns): jpcap.write_pcap(pkts, ts, endian=endian, nanosecond=ns)
        for endian in ("<", ">") for ns in (False, True)
    }
    raws.update({("pcapng", endian, False): jpcap.write_pcapng(pkts, ts, endian=endian)
                 for endian in ("<", ">")})
    return pkts, ts, labels, raws


def _same_capture(a, b):
    assert (a.fmt, a.linktype) == (b.fmt, b.linktype)
    np.testing.assert_array_equal(a.data, b.data)
    np.testing.assert_array_equal(a.lengths, b.lengths)
    np.testing.assert_array_equal(a.timestamps, b.timestamps)


@pytest.mark.parametrize("seed,flood", [(0, 0.35), (3, 0.35), (11, 0.9)])
def test_synthesize_capture_matches_reference(seed, flood):
    tp, tt, tl = tpcap.synthesize_capture(N, seed=seed, flood_frac=flood)
    jp, jt, jl = jpcap.synthesize_capture(N, seed=seed, flood_frac=flood)
    assert tp == jp
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(tl, jl)


def test_writers_are_byte_identical(capture):
    pkts, ts, _, raws = capture
    for (fmt, endian, ns), raw in raws.items():
        if fmt == "pcap":
            mine = tpcap.write_pcap(pkts, ts, endian=endian, nanosecond=ns)
        else:
            mine = tpcap.write_pcapng(pkts, ts, endian=endian)
        assert mine == raw, (fmt, endian, ns)


def test_writers_to_files_round_trip(capture, tmp_path):
    pkts, ts, _, _ = capture
    tpcap.write_pcap(pkts, ts, path=tmp_path / "t.pcap")
    tpcap.write_pcapng(pkts, ts, path=tmp_path / "t.pcapng")
    for name in ("t.pcap", "t.pcapng"):
        assert tpcap.read_pcap(tmp_path / name).packets() == pkts
        _same_capture(tpcap.read_pcap(tmp_path / name), jpcap.read_pcap(tmp_path / name))


def test_readers_agree_on_reference_bytes(capture):
    pkts, _, _, raws = capture
    for raw in raws.values():
        cap = tpcap.read_pcap(raw)
        _same_capture(cap, jpcap.read_pcap(raw))
        assert cap.packets() == pkts


def test_readers_refuse_truncated_bytes_alike(capture):
    _, _, _, raws = capture
    for raw in (raws["pcap", "<", False], raws["pcapng", "<", False]):
        for cut in (len(raw) - 3, 10):
            with pytest.raises(jpcap.PcapFormatError):
                jpcap.read_pcap(raw[:cut])
            with pytest.raises(tpcap.PcapFormatError):
                tpcap.read_pcap(raw[:cut])


def test_parse_headers_featurize_and_labels_match(capture):
    _, _, _, raws = capture
    raw = raws["pcapng", "<", False]
    tcap, jcap = tpcap.read_pcap(raw), jpcap.read_pcap(raw)
    tf, jf = tpcap.parse_headers(tcap), jpcap.parse_headers(jcap)
    for field in dataclasses.fields(jf):
        np.testing.assert_array_equal(getattr(tf, field.name), getattr(jf, field.name))
    for width in (None, 8, 32, 64, 136, 200):
        np.testing.assert_array_equal(tpcap.featurize(tcap, width), jpcap.featurize(jcap, width))
    rule = lambda f: (f.proto == 6).astype(int) + 2 * (f.iat_bucket > 3)  # noqa: E731
    np.testing.assert_array_equal(tpcap.label_packets(tcap, rule),
                                  jpcap.label_packets(jcap, rule, fields=jf))
    assert tpcap.PCAP_FEATURE_BITS == jpcap.PCAP_FEATURE_BITS
    assert tpcap.FEATURE_LAYOUT == jpcap.FEATURE_LAYOUT


def test_registered_pcap_scenario_generates_the_reference_packets(capture):
    _, _, _, raws = capture
    raw = raws["pcap", ">", True]
    name = "torch_pcap_parity"
    ts = tpcap.register_pcap_scenario(name, raw, overwrite=True)
    js = jpcap.register_pcap_scenario(name, raw, overwrite=True)
    assert ttr.get_scenario(name) is ts and ts.description == js.description
    for bits in (16, 136):
        want = jtr.generate(name, 2 * N + 7, bits, seed=5)
        np.testing.assert_array_equal(ttr.generate(name, 2 * N + 7, bits, seed=5), want)
        chunks = list(ttr.stream(name, 2 * N + 7, bits, chunk_size=97, seed=1))
        np.testing.assert_array_equal(np.concatenate(chunks), want)
    with pytest.raises(ValueError, match="already registered"):
        tpcap.register_pcap_scenario(name, raw)
    # A capture tenant beside a synthetic one: the mixed stream is the
    # reference's, chunk by chunk.
    specs = [(name, 24, 1.0), ("ddos_burst", 16, 2.0)]
    tspec = [ttr.TenantTrafficSpec(*s) for s in specs]
    jspec = [jtr.TenantTrafficSpec(*s) for s in specs]
    for (ti, tb), (ji, jb) in zip(ttr.mixed_tenant_stream(tspec, 500, chunk_size=130, seed=2),
                                  jtr.mixed_tenant_stream(jspec, 500, chunk_size=130, seed=2)):
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tb, jb)
