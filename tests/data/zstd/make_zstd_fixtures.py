"""Writes the Zstandard frames that ``chip_smoke.py`` and the TIFF codec
tests hold the port's decoder to (``*.zst``), and ``digests.json``: each
frame's content length and SHA-256 as ``zstandard`` decodes it.

The frames together take every block type (raw, RLE, compressed), every
literals type (raw, RLE, Huffman in one and in four streams, treeless),
both kinds of Huffman weights (direct and FSE-coded), every sequence table
mode (predefined, RLE, FSE, repeat) for literal lengths, offsets and match
lengths, content checksums, and a skippable frame before a frame;
``fern_strip_p2`` is a 4032x16 RGB strip after TIFF predictor 2, which
``chip_smoke.py`` repeats down a 4032x3024 page for its decode time.  The
payloads come from a seeded numpy generator, so the files are the same on
every run with the same ``zstandard`` (0.25.0 wrote the committed ones):

    python tests/data/zstd/make_zstd_fixtures.py
"""
import hashlib
import json
import struct
from pathlib import Path

import numpy as np
import zstandard

HERE = Path(__file__).resolve().parent


def payloads():
    rng = np.random.RandomState(0)
    words = [b"alpha", b"beta", b"gamma", b"delta", b"epsilon", b"zeta"]
    aab = lambda n: (b"a" * 40 + b"b") * (n // 41)
    runs = lambda n: bytes(np.repeat(rng.randint(0, 3, n // 50), 50).astype(np.uint8))
    out = {
        "aab_predefined": (aab(300), 9),
        "aab_ll_rle": (aab(300), 1),
        "aab_one_stream": (aab(3000), 1),
        "grad_ml_rle": ((np.arange(300) // 7 % 256).astype(np.uint8).tobytes(), 19),
        "runs_of_rle": (runs(300), 1),
        "runs_of_fse": (runs(3000), 19),
        "small_four_streams": (bytes(rng.randint(0, 4, 300).astype(np.uint8)), 19),
        "noise_raw_block": (bytes(rng.randint(0, 256, 300).astype(np.uint8)), -5),
        "few_direct_weights": (bytes(rng.choice([1, 2, 3, 9], 3000).astype(np.uint8)), 3),
    }
    big_runs = runs(200000)
    out["runs_treeless_repeat"] = (big_runs, 9)
    out["runs_ll_repeat"] = (big_runs, 19)
    r = bytes(rng.randint(0, 256, 3000).astype(np.uint8))
    out["rle_literals"] = (r + b"".join(r[i * 7 % 2000:i * 7 % 2000 + 500] + b"x"
                                        for i in range(400)), 19)
    out["words_ml_repeat"] = (b" ".join(rng.choice(words, 40000)), 9)
    return out


def rle_blocks() -> bytes:
    """A frame of flushed blocks, one a run of a byte (an RLE block)."""
    c = zstandard.ZstdCompressor(level=3, write_checksum=True).compressobj()
    parts = [c.compress(b"header " * 20), c.flush(zstandard.COMPRESSOBJ_FLUSH_BLOCK),
             c.compress(b"\x07" * 5000), c.flush(zstandard.COMPRESSOBJ_FLUSH_BLOCK),
             c.compress(b"tail " * 30), c.flush()]
    return b"".join(parts), b"header " * 20 + b"\x07" * 5000 + b"tail " * 30


def fern_strip() -> bytes:
    """A 4032x16 RGB strip as TIFF predictor 2 leaves it (each row's
    horizontal differences, modulo 256): the content of the frame that
    ``chip_smoke.py`` repeats down a 4032x3024 TIFF."""
    x = np.arange(4032, dtype=np.float64)[None, :]
    y = np.arange(16, dtype=np.float64)[:, None]
    rgb = np.stack([128 + 100 * np.sin(x / 37) + 0 * y,
                    128 + 100 * np.cos(y / 5) + 0 * x,
                    128 + 60 * np.sin((x + y) / 51)], -1)
    rgb += np.random.RandomState(1).normal(0, 2, rgb.shape)
    strip = np.clip(rgb, 0, 255).astype(np.uint8)
    strip[:, :600] = strip[:, :600] // 32 * 32
    d = strip.astype(np.int16)
    d[:, 1:] = d[:, 1:] - strip[:, :-1]
    return (d & 255).astype(np.uint8).tobytes()


def main():
    digests = {}

    def write(name, frame, content):
        (HERE / f"{name}.zst").write_bytes(frame)
        digests[name] = {"size": len(content),
                         "sha256": hashlib.sha256(content).hexdigest()}

    for name, (data, level) in payloads().items():
        frame = zstandard.ZstdCompressor(level=level, write_checksum=True).compress(data)
        write(name, frame, data)
    data = fern_strip()
    write("fern_strip_p2", zstandard.ZstdCompressor(
        level=9, write_checksum=True).compress(data), data)
    frame, content = rle_blocks()
    write("rle_block", frame, content)
    skip = struct.pack("<II", 0x184D2A53, 9) + b"skip this"
    data = b"after a skippable frame " * 10
    write("skippable", skip + zstandard.ZstdCompressor(level=3).compress(data), data)
    (HERE / "digests.json").write_text(json.dumps(digests, indent=1, sort_keys=True) + "\n")


if __name__ == "__main__":
    main()
