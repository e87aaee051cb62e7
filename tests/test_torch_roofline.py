"""The port's roofline formulas, report tables and hillclimb levers
against the JAX package's, on the CPU.

Ring accounting: `repro_torch.analysis.roofline.ring_wire_bytes` against
JAX's ``parse_collectives`` on one synthesized HLO line per op kind and
group size.  ``Roofline`` and ``model_flops_per_step`` against JAX's on the
same inputs, with JAX's constants patched to the H100's (the JAX package
is not edited).  The report's three tables against JAX's functions on the
same dicts: only the HBM column differs (80 GB per H100, 16 GB per v5e).
The hillclimb's tags and environment levers against JAX's
``apply_variant``, and the two levers the port refuses.
"""

from __future__ import annotations

import json
import os

import pytest

from repro.analysis import report as jreport
from repro.analysis import roofline as jrl
from repro_torch.analysis import report, roofline as rl

SIZES = (2, 4, 16)
HLO_OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute")


def _hlo_line(op: str, n: int, dims=(8, 1024)) -> str:
    shape = ",".join(str(d) for d in dims)
    return (f"  %x.1 = bf16[{shape}]{{1,0}} {op}(bf16[{shape}]{{1,0}} %p.0), "
            f"replica_groups=[{256 // n},{n}]<=[256], channel_id=1")


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("op", HLO_OPS)
def test_ring_wire_bytes_match_parse_collectives(op, n):
    nbytes = 8 * 1024 * 2
    want = jrl.parse_collectives(_hlo_line(op, n), 256)
    assert want.counts == {op: 1}
    assert rl.ring_wire_bytes(op, nbytes, n) == pytest.approx(want.wire_bytes, rel=1e-12)
    stats = rl.CollectiveStats()
    stats.add(op, nbytes, n)
    assert stats.by_op == pytest.approx(want.by_op) and stats.counts == want.counts


def test_ring_wire_bytes_of_one_rank_and_unknown_ops():
    assert rl.ring_wire_bytes("all-reduce", 1e6, 1) == 0.0
    stats = rl.CollectiveStats()
    stats.add("all-gather", 1e6, 1)
    assert stats.counts == {} and stats.wire_bytes == 0.0
    with pytest.raises(ValueError):
        rl.ring_wire_bytes("broadcast", 1.0, 4)


@pytest.mark.parametrize("shape,axes,want", [
    ((16, 16), [1], "network"),  # the model axis spans 16 ranks: two nodes
    ((16, 16), [0], "network"),
    ((2, 16, 16), [0], "network"),
    ((2, 2), [0], "nvlink"),
    ((2, 2), [0, 1], "nvlink"),
    ((1, 8), [1], "nvlink"),
    ((4, 2), [0], "nvlink"),
    ((2, 8), [0], "network"),
    ((4, 4), [1], "nvlink"),
])
def test_group_link(shape, axes, want):
    assert rl.group_link(shape, axes) == want


def test_collective_time_takes_each_links_rate():
    stats = rl.CollectiveStats()
    stats.add("all-reduce", 1e6, 2, "nvlink")
    assert stats.link() == ("nvlink", rl.NVLINK_BW)
    stats.add("all-gather", 1e6, 16, "network")
    kind, rate = stats.link()
    assert kind == "mixed" and stats.wire_bytes / rate == pytest.approx(stats.time_s)
    assert stats.time_s == pytest.approx(1e6 / rl.NVLINK_BW + 15 / 16 * 1e6 / rl.NETWORK_BW)


CASES = [
    dict(n_devices=256, flops=2.6e14, bytes=1.2e13, coll=2.6e11, mf=5e16, link="network"),
    dict(n_devices=512, flops=1.3e11, bytes=6e12, coll=1e9, mf=1e13, link="nvlink"),
    dict(n_devices=4, flops=1e9, bytes=1e12, coll=0.0, mf=4e9, link="nvlink"),
    dict(n_devices=1, flops=0.0, bytes=0.0, coll=0.0, mf=0.0, link="nvlink"),
]


@pytest.mark.parametrize("case", CASES)
def test_roofline_matches_jax_at_the_h100_constants(case, monkeypatch):
    bw = rl.LINK_BW[case["link"]]
    monkeypatch.setattr(jrl, "PEAK_FLOPS", rl.PEAK_FLOPS)
    monkeypatch.setattr(jrl, "HBM_BW", rl.HBM_BW)
    monkeypatch.setattr(jrl, "LINK_BW", bw)
    kw = dict(arch="a", shape="s", mesh="m", n_devices=case["n_devices"],
              hlo_flops_per_device=case["flops"], hlo_bytes_per_device=case["bytes"],
              collective_bytes_per_device=case["coll"], model_flops=case["mf"],
              collective_by_op={"all-gather": case["coll"]},
              collective_counts={"all-gather": 3}, memory_stats={"argument_bytes": 1})
    want = jrl.Roofline(**kw).finalize()
    got = rl.Roofline(**kw, link=case["link"], link_bw=bw).finalize()
    d = got.to_dict()
    assert d.pop("link") == case["link"] and d.pop("link_bw") == bw
    assert d == want.to_dict()
    assert got.roofline_fraction() == want.roofline_fraction()
    assert got.step_time_bound_s() == want.step_time_bound_s()


@pytest.mark.parametrize("kind", ["train", "serve", "prefill"])
def test_model_flops_per_step_matches_jax(kind):
    for total, active, tokens in ((8_030_000_000, 8_030_000_000, 1 << 20), (7e9, 1.3e9, 4096)):
        assert rl.model_flops_per_step(total, active, tokens, kind) == \
            jrl.model_flops_per_step(total, active, tokens, kind)


def _cells():
    out = []
    for i, (arch, shape, mesh) in enumerate([("llama3-8b", "train_4k", "16x16"),
                                             ("olmoe-1b-7b", "decode_32k", "2x16x16"),
                                             ("deepseek-v3-671b", "prefill_32k", "16x16")]):
        roof = rl.Roofline(arch=arch, shape=shape, mesh=mesh, n_devices=256 * (1 + i % 2),
                           hlo_flops_per_device=1e14 / (i + 1), hlo_bytes_per_device=1e12 * i,
                           collective_bytes_per_device=3e10 * (i + 1), model_flops=5e16,
                           memory_stats={"argument_bytes": [3e9, 9e10, 4e10][i],
                                         "output_bytes": 1e9, "temp_bytes": -1,
                                         "alias_bytes": 1e9}).finalize()
        d = roof.to_dict()
        d.update(compile_s=1.5 * i, variant=["baseline", "axis-fsdp_all", "sp-1"][i])
        out.append(d)
    return out


@pytest.mark.parametrize("table", ["dryrun_table", "roofline_table", "perf_table"])
def test_report_tables_match_jax(table):
    cells = _cells()
    got = getattr(report, table)(cells)
    want = getattr(jreport, table)(cells)
    if table != "dryrun_table":
        assert got == want
        return
    # only the HBM column differs: 80 GB per H100 against 16 GB per v5e
    assert got.replace("fits 80G", "fits 16G").splitlines()[:2] == want.splitlines()[:2]
    for g, w, d in zip(got.splitlines()[2:], want.splitlines()[2:], cells):
        gc, wc = g.split(" | "), w.split(" | ")
        assert gc[:6] + gc[7:] == wc[:6] + wc[7:]
        arg = d["memory_stats"]["argument_bytes"]
        assert gc[6] == ("yes" if arg <= 80e9 else "NO")
        assert wc[6] == ("yes" if arg <= 16e9 else "NO")
    assert report.fmt_bytes(-1) == jreport.fmt_bytes(-1) == "-"


def test_report_reads_the_ports_folders(tmp_path, monkeypatch, capsys):
    for name in ("dryrun_torch", "perf_torch"):
        (tmp_path / "reports" / name).mkdir(parents=True)
    for i, d in enumerate(_cells()):
        (tmp_path / "reports" / "dryrun_torch" / f"{i}.json").write_text(json.dumps(d))
    (tmp_path / "reports" / "perf_torch" / "p.json").write_text(json.dumps(_cells()[1]))
    monkeypatch.setattr(report, "ROOT", str(tmp_path))
    monkeypatch.setattr("sys.argv", ["report"])
    report.main()
    out = capsys.readouterr().out
    assert "fits 80G" in out and "## §Perf variants" in out
    assert out.count("| llama3-8b | train_4k | 16x16 |") == 2


SHARED = [["axis=tp_model"], ["axis=fsdp_all"], ["sp=0"], ["sp=1"], ["ce=fused"], ["ce=plain"],
          ["mb=4"], ["moe_group=512"], ["remat=nothing"], ["remat=none"],
          ["axis=fsdp_all", "sp=1", "mb=2"], []]
ENV = ("REPRO_AXIS_MAP", "REPRO_SEQ_PARALLEL", "REPRO_FUSED_CE", "REPRO_REMAT_POLICY")


@pytest.mark.parametrize("tokens", SHARED, ids=lambda t: "_".join(t) or "baseline")
def test_hillclimb_levers_match_jax(tokens, monkeypatch):
    # importing JAX's hillclimb imports its dryrun, which sets XLA_FLAGS and
    # REPRO_REMAT_POLICY in os.environ: monkeypatch restores both after
    for k in ENV + ("XLA_FLAGS",):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    from repro.launch import hillclimb as jhc
    from repro_torch.launch import hillclimb as hc

    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    jkw, jtag = jhc.apply_variant(tokens)
    jenv = {k: os.environ.get(k) for k in ENV}
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    kw, tag = hc.apply_variant(tokens)
    env = {k: os.environ.get(k) for k in ENV}
    assert tag == jtag
    # JAX picks the remat policy by environment, the port by keyword
    remat = jenv.pop("REPRO_REMAT_POLICY")
    assert env.pop("REPRO_REMAT_POLICY") is None
    assert env == jenv
    if remat is None:
        assert "remat" not in kw
    else:
        assert kw.pop("remat") == (remat == "nothing")
    assert kw == jkw


@pytest.mark.parametrize("tokens,why", [(["remat=dots"], "dots-saveable"),
                                         (["pbf16=1"], "fp32")])
def test_hillclimb_refuses_levers_the_port_lacks(tokens, why, monkeypatch):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    from repro_torch.launch import hillclimb as hc

    with pytest.raises(ValueError, match=why):
        hc.apply_variant(tokens)
