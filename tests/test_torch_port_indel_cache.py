"""``mural_indel predict --with_h5`` through the port's CLI on the CPU, on
a mural_tpu-written INDEL triple: the cold run writes the site-table
cache, the warm run reads it, and both TSVs equal (decompressed) the
TSV of a predict without the cache; the cache is the one mural_tpu's
loader reads."""
import gzip

import numpy as np

from mural_tpu.data.cache import is_cache_fresh
from mural_tpu_torch.cli.mural_indel import main as port_cli
from test_torch_port_indel_cli import _predict_argv, data, triple  # noqa
from test_torch_port_indel_model import one_torch_thread  # noqa: F401


def test_indel_predict_with_h5(data, triple, tmp_path, capsys):
    _, fasta, bed = data
    outs = {}
    for name, extra in (("plain", []),
                        ("cold", ["--with_h5", "--h5f_path",
                                  str(tmp_path / "h5")]),
                        ("warm", ["--with_h5", "--h5f_path",
                                  str(tmp_path / "h5")])):
        out = str(tmp_path / f"{name}.tsv.gz")
        assert port_cli(_predict_argv(fasta, bed, triple, out, *extra)) == 0
        outs[name] = capsys.readouterr().out
        with gzip.open(out, "rt") as fh:
            outs[name + "_tsv"] = fh.read()
    assert "wrote site-encoding cache (1 file(s)):" in outs["cold"]
    assert "using cached site encodings:" in outs["warm"]
    assert outs["cold_tsv"] == outs["plain_tsv"] == outs["warm_tsv"]
    assert len(outs["plain_tsv"].splitlines()) == 1 + sum(1 for _ in
                                                          open(bed))
    (cache,) = (tmp_path / "h5").glob("*.indel.*.sites.h5")
    assert is_cache_fresh(str(cache), bed)
    assert np.isfinite([float(v) for v in outs["warm_tsv"].splitlines()[1]
                        .split("\t")[5:]]).all()
