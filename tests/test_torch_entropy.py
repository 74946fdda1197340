"""The port's entropy coding against the JAX package's, on the CPU.

The CDF quantizers must give the JAX package's integer CDFs, raising on the
same pdfs; the port's Python range coder (the plain version) and its native
C++ coder must write the bytes of the JAX package's ``encode_symbols`` for
the same CDFs and symbols, and each must decode the others' streams.
"""

import io

import numpy as np
import pytest

from neuralcodecs_tpu.models.encodec import entropy as jentropy
from neuralcodecs_tpu.native.entropy_native import encode_symbols as jencode_symbols
from neuralcodecs_tpu_torch.models.encodec import entropy
from neuralcodecs_tpu_torch.native import build
from neuralcodecs_tpu_torch.native.entropy_native import NativeArithmeticDecoder, encode_symbols


def _pdfs(rng, n: int, card: int, concentration: float) -> np.ndarray:
    """Dirichlet rows scaled just under 1, so their f32 sums stay below 1 as
    an f32 softmax's do (tests/test_entropy_cross.py)."""
    return (rng.dirichlet(np.full(card, concentration), size=n) * (1.0 - 1e-5)).astype(np.float32)


def _stream(seed: int, n: int, card: int, concentration: float):
    rng = np.random.default_rng(seed)
    pdfs = _pdfs(rng, n, card, concentration)
    symbols = np.array([rng.choice(card, p=p / p.sum()) for p in pdfs], np.int32)
    return jentropy.build_stable_quantized_cdf_batch(pdfs), symbols


def _python_encode(cdfs, symbols) -> bytes:
    buf = io.BytesIO()
    coder = entropy.ArithmeticCoder(buf)
    for s, cdf in zip(symbols, cdfs):
        coder.push(int(s), cdf)
    coder.flush()
    return buf.getvalue()


def _python_decode(blob: bytes, cdfs) -> list[int]:
    dec = entropy.ArithmeticDecoder(io.BytesIO(blob))
    return [dec.pull(cdf) for cdf in cdfs]


@pytest.mark.parametrize("card", [2, 17, 64, 1024])
def test_cdf_quantizers_match_jax(card):
    rng = np.random.default_rng(card)
    pdfs = _pdfs(rng, 32, card, 0.3)
    want = jentropy.build_stable_quantized_cdf_batch(pdfs)
    got = entropy.build_stable_quantized_cdf_batch(pdfs)
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    for i in (0, 7, 31):
        np.testing.assert_array_equal(entropy.build_stable_quantized_cdf(pdfs[i]),
                                      jentropy.build_stable_quantized_cdf(pdfs[i]))
    # a [..., card] batch of several leading axes, and other range bits
    np.testing.assert_array_equal(
        entropy.build_stable_quantized_cdf_batch(pdfs.reshape(4, 8, card), 20),
        jentropy.build_stable_quantized_cdf_batch(pdfs.reshape(4, 8, card), 20))


def test_cdf_quantizer_error_agreement():
    """f32 casts of exact-1.0 two-way dirichlet rows that sum above 1
    overflow the range: the port raises on exactly the rows JAX raises on,
    and gives JAX's CDF on the others (tests/test_entropy_cross.py)."""
    rng = np.random.default_rng(3)
    rejected = 0
    for _ in range(200):
        p = rng.dirichlet(np.full(2, 0.5)).astype(np.float32)
        results = []
        for mod in (jentropy, entropy):
            for fn, arg in ((mod.build_stable_quantized_cdf, p),
                            (mod.build_stable_quantized_cdf_batch, p[None])):
                try:
                    results.append(np.asarray(fn(arg)).reshape(-1).tolist())
                except ValueError:
                    results.append("error")
        assert all(r == results[0] for r in results), results
        rejected += results[0] == "error"
    assert 0 < rejected < 200


@pytest.mark.parametrize("mod", ["jax", "port"])
def test_cdf_quantizer_refusals(mod):
    m = jentropy if mod == "jax" else entropy
    with pytest.raises(ValueError):  # oversubscribed alphabet: alpha > 1
        m.build_stable_quantized_cdf(np.full(1 << 20, 2 ** -20, np.float32), total_range_bits=20)
    with pytest.raises(ValueError):  # a range below min_range (a negative pdf entry)
        m.build_stable_quantized_cdf_batch(np.array([[0.5, -0.25, 0.5]], np.float32))
    with pytest.raises(ValueError):  # the total exceeds the range
        m.build_stable_quantized_cdf(np.array([0.7, 0.7], np.float32))


CASES = [
    # (seed, symbols, cardinality, dirichlet concentration)
    (0, 400, 1024, 0.05),   # the Encodec LM's regime: sharp pdfs over 1024 codes
    (1, 400, 1024, 1.0),    # flat pdfs
    (2, 2000, 64, 0.02),    # a long, very peaked stream (carries)
    (3, 2000, 2, 0.5),      # binary alphabet
    (4, 800, 17, 5.0),      # odd cardinality, smooth pdfs
]


@pytest.mark.parametrize("seed,n,card,conc", CASES)
def test_coders_write_jax_bytes_and_read_each_other(seed, n, card, conc):
    cdfs, symbols = _stream(seed, n, card, conc)
    want = jencode_symbols(cdfs, symbols)
    native = encode_symbols(cdfs, symbols)
    python = _python_encode(cdfs, symbols)
    assert native == want
    assert python == want
    with NativeArithmeticDecoder(want) as dec:
        np.testing.assert_array_equal(dec.pull_many(cdfs), symbols)
    with NativeArithmeticDecoder(want) as dec:
        assert [dec.pull(c) for c in cdfs[:50]] == symbols[:50].tolist()
    assert _python_decode(native, cdfs) == symbols.tolist()


def test_native_coder_checks_its_inputs_and_the_stream_end():
    cdfs, symbols = _stream(5, 64, 32, 0.5)
    with pytest.raises(ValueError):
        encode_symbols(cdfs, symbols[:-1])
    with pytest.raises(ValueError):
        encode_symbols(cdfs, np.full(64, 32, np.int32))
    blob = encode_symbols(cdfs, symbols)
    with NativeArithmeticDecoder(blob[:2]) as dec, pytest.raises(RuntimeError):
        dec.pull_many(cdfs)
    assert encode_symbols(cdfs[:0], symbols[:0]) == jencode_symbols(cdfs[:0], symbols[:0])


def test_native_coder_is_built_beside_the_kernels():
    """g++ builds the coder into the package's git-ignored _build/, under a
    name that hashes the source, and the loaded library is that file."""
    lib = build.entropy_lib()
    path = build.library_path()
    assert path.parent == build.BUILD_DIR
    assert build.BUILD_DIR.name == "_build"
    assert build.BUILD_DIR.parent.name == "neuralcodecs_tpu_torch"
    assert path.is_file() and lib._name == str(path)


def test_bit_packers_match_jax():
    rng = np.random.default_rng(0)
    for bits in (1, 5, 10, 24):
        values = rng.integers(0, 1 << bits, size=211)
        streams = []
        for mod in (jentropy, entropy):
            buf = io.BytesIO()
            packer = mod.BitPacker(bits, buf)
            packer.push_many(values)
            packer.flush()
            streams.append(buf.getvalue())
        assert streams[0] == streams[1]
        unpacker = entropy.BitUnpacker(bits, io.BytesIO(streams[1]))
        assert [unpacker.pull() for _ in values] == values.tolist()
