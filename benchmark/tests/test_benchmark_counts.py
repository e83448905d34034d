"""The frozen counts against the numbers PERF.md records for the headline
shapes, and the layout against the port's own sizing."""

import pytest

from benchmark import core
from benchmark.counts import flops, kernel_bytes, peaks
from benchmark.counts.layout import layout, promo_cap

MAN = core.manifest()
HBM = 3.35e12


def _lay(name):
    return layout(core.config(MAN, name))


def test_benchmark_tower_flops():
    k = _lay("dlrm_kaggle_cafe")
    assert flops.train_flops_per_example(k["ln_bot"], k["ln_top"], 26,
                                         16) == 2_916_192
    # the Criteo-Terabyte DLRM's towers (bench/criteo_terabyte.sh)
    assert flops.train_flops_per_example(
        [13, 512, 256, 128], [479, 1024, 1024, 512, 256, 1], 26,
        128) == 14_750_976


def test_benchmark_land_bytes_at_the_headline():
    # PERF.md's kernel table: K1 at [53,248, 5, 9,646], bound 0.000439 ms
    lay = _lay("dlrm_kaggle_cafe")
    c = lay["cafe"]
    lanes = 2048 * c["lanes_per_row"]
    assert (lanes, c["land_channels"], c["hotn"]) == (53248, 5, 9646)
    ms = kernel_bytes.land_bytes(lanes, 5, 9646) / HBM * 1e3
    assert round(ms, 6) == 0.000439


def test_benchmark_peaks_refuse_an_unknown_card():
    assert peaks.peak("NVIDIA H100 80GB HBM3", "bf16_flops") == 989e12
    assert peaks.peak("NVIDIA H100 80GB HBM3", "hbm_bytes_per_s") == HBM
    with pytest.raises(ValueError):
        peaks.peak("some other card", "bf16_flops")


@pytest.mark.parametrize("name", [c["name"] for c in MAN["configs"]])
def test_benchmark_layout_matches_the_port(name):
    from cafe_tpu_torch.embeddings import (CafePart, HashedTablePart,
                                           build_embedding_layer)
    from cafe_tpu_torch.train import model_arch

    from benchmark.systems.dlrm_cafe import make_config
    conf = core.config(MAN, name)
    lay = layout(conf)
    cfg = make_config(conf, {})
    layer = build_embedding_layer(cfg, lay["counts"], lay["dim"], None,
                                  device="cpu")
    cafe = [p for p in layer.parts if isinstance(p, CafePart)]
    full = [p for p in layer.parts if isinstance(p, HashedTablePart)]
    assert len(cafe) == 1 and len(full) == (lay["full"] is not None)
    p, c = cafe[0], lay["cafe"]
    assert (p.hotn, p.hash_sizes, p.hash_base, p.total_rows, p.field_idx) \
        == (c["hotn"], c["hash_sizes"], c["hash_base"], c["rows"], lay["big"])
    assert p.sketch_cfg.max_id == c["max_id"]
    if full:
        assert full[0].real_ns == lay["full"]["real_ns"]
        assert full[0].field_idx == lay["small"]
    assert list(model_arch(cfg, 13, 26)) == [lay["ln_bot"], lay["ln_top"]]
    assert promo_cap(lay, 2048) == min(
        min(2048 * len(lay["big"]), 4096), p.hotn,
        max(p.mig_lanes * 16, 4096))
