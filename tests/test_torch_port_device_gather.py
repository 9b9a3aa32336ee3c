"""The port's window gather and encoding for genome-wide predict
(mural_tpu_torch.ops.device_gather) against the JAX package's
(mural_tpu.ops.device_gather, run on the CPU) and against the port's host
pipeline: bit-equal categorical ids, one-hots and codes for SNV
``local_order`` 1/2/3 and INDEL, both strands, IUPAC codes and N, and
sites at both ends of the chunk; ``iter_code_chunks`` equal to JAX's."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mural_tpu.genome.fasta import Genome as JGenome
from mural_tpu.ops.device_gather import iter_code_chunks as j_chunks
from mural_tpu.ops.device_gather import make_batch_code_encoder as j_code
from mural_tpu.ops.device_gather import make_batch_encoder as j_encoder
from mural_tpu.ops.window_gather import pad_arena_rows
from mural_tpu_torch import native
from mural_tpu_torch.genome import encode as enc
from mural_tpu_torch.genome.fasta import N_CODE, Genome, decode_sequence
from mural_tpu_torch.ops.device_gather import (iter_code_chunks,
                                               make_batch_code_encoder,
                                               make_batch_encoder)

LOCAL_RADIUS, DISTAL_RADIUS = 4, 30
N_CHUNK, MARGIN = 2000, 40


@pytest.mark.parametrize("model_type,local_order", [
    ("snv", 1), ("snv", 2), ("snv", 3), ("indel", 1)])
def test_encoders_match_jax_and_host(model_type, local_order):
    rng = np.random.default_rng(local_order)
    codes = rng.integers(0, 15, size=N_CHUNK).astype(np.uint8)
    padded = np.concatenate([np.full(MARGIN, N_CODE, np.uint8), codes,
                             np.full(MARGIN, N_CODE, np.uint8)])
    pos = np.concatenate([[0, 1, N_CHUNK - 2, N_CHUNK - 1],
                          rng.integers(0, N_CHUNK, 60)]).astype(np.int64)
    neg = rng.random(len(pos)) < 0.5
    neg[:4] = [False, True, False, True]

    # the host pipeline
    lw = enc.window_size(LOCAL_RADIUS, 1, model_type)
    dw = enc.window_size(DISTAL_RADIUS, 1, model_type)
    lstart = enc.expanded_start(pos, LOCAL_RADIUS, model_type)
    dstart = enc.expanded_start(pos, DISTAL_RADIUS, model_type)
    lwin = native.gather_windows(codes, lstart, lw, neg)
    dwin = native.gather_windows(codes, dstart, dw, neg)
    cat_host = (native.kmer_pack(lwin, local_order) if local_order > 1
                else enc.order1_local(lwin).astype(np.int64))

    # the port, on the CPU
    chunk = torch.from_numpy(padded)
    args = (chunk, torch.from_numpy(lstart + MARGIN),
            torch.from_numpy(dstart + MARGIN), torch.from_numpy(neg))
    encode, lw2, dw2 = make_batch_encoder(LOCAL_RADIUS, local_order,
                                          DISTAL_RADIUS, model_type)
    assert (lw2, dw2) == (lw, dw)
    cat, oh = encode(*args)
    code_encode, _, _ = make_batch_code_encoder(LOCAL_RADIUS, local_order,
                                                DISTAL_RADIUS, model_type)
    cat2, dcodes = code_encode(*args)
    assert cat.dtype == cat2.dtype == torch.int64
    assert dcodes.dtype == torch.uint8 and oh.dtype == torch.float32

    # the JAX package's, on (R, 128) rows of the same padded chunk
    j_args = (jnp.asarray(pad_arena_rows(padded, dw)),
              jnp.asarray(lstart + MARGIN, jnp.int32),
              jnp.asarray(dstart + MARGIN, jnp.int32), jnp.asarray(neg))
    j_cat, j_oh = j_encoder(LOCAL_RADIUS, local_order, DISTAL_RADIUS,
                            model_type)[0](*j_args)
    j_cat2, j_dcodes = j_code(LOCAL_RADIUS, local_order, DISTAL_RADIUS,
                              model_type)[0](*j_args)

    for got in (cat.numpy(), cat2.numpy()):
        np.testing.assert_array_equal(got, cat_host)
        np.testing.assert_array_equal(got, np.asarray(j_cat))
    np.testing.assert_array_equal(np.asarray(j_cat2), cat_host)
    np.testing.assert_array_equal(oh.numpy(), enc.ONE_HOT_TABLE[dwin])
    np.testing.assert_array_equal(oh.numpy(), np.asarray(j_oh))
    np.testing.assert_array_equal(dcodes.numpy(), dwin)
    np.testing.assert_array_equal(dcodes.numpy(), np.asarray(j_dcodes))


@pytest.mark.parametrize("chunk", [1024, 4096])
def test_iter_code_chunks_matches_jax(tmp_path, chunk):
    rng = np.random.default_rng(chunk)
    fasta = tmp_path / "g.fa"
    with open(fasta, "w") as fh:
        for chrom, n in (("chr1", 3000), ("2", 90)):
            fh.write(f">{chrom}\n"
                     f"{decode_sequence(rng.integers(0, 15, n))}\n")
    g, jg = Genome.from_fasta(str(fasta)), JGenome.from_fasta(str(fasta))
    for chrom in ("chr1", "2"):
        got = list(iter_code_chunks(g, chrom, 50, chunk))
        want = list(j_chunks(jg, chrom, 50, chunk))
        assert len(got) == len(want) == -(-len(g[chrom]) // chunk)
        for (lo, hi, padded), (jlo, jhi, jpadded) in zip(got, want):
            assert (lo, hi) == (jlo, jhi)
            assert padded.dtype == np.uint8
            np.testing.assert_array_equal(padded, jpadded)
