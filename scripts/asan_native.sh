#!/usr/bin/env bash
# AddressSanitizer run of the native host library (the analog of the
# reference's ASan+UBSan CI smoke test, scripts/ci/ubuntu/02-build.sh).
set -euo pipefail
ROOT="$(cd "$(dirname "$0")/.." && pwd)"
BUILD=$(mktemp -d)
g++ -O1 -g -std=c++17 -fPIC -fsanitize=address,undefined -shared \
    -o "$BUILD/libslimt_host_asan.so" "$ROOT/native/slimt_host.cpp"
cat > "$BUILD/check.py" <<'EOF'
import sys, os
sys.path.insert(0, os.environ["SLIMT_ROOT"])
import slimt_jax.native as native
native._LIB_PATH = os.environ["ASAN_LIB"]
native._lib = None; native._build_failed = False
assert native.available()
from slimt_jax.text.synthetic_vocab import build_vocabulary
py = build_vocabulary(["hello", "world", "test", "héllo"], backend="none")
nat = build_vocabulary(["hello", "world", "test", "héllo"], backend="native")
lines = ["hello world", "  spaces   collapse  ", "héllo zzz", "",
         "x" * 500, "hello " * 300, "punctuation, works. fine?"]
for line in lines:
    assert py.encode(line) == nat.encode(line), line[:40]
    ids = py.encode(line)[0] + [py.eos_id]
    assert py.decode(ids) == nat.decode(ids)

# batch entry points: encode_batch_begins / ingest_lines (both forms)
nv = nat._native
got = nv.encode_batch_begins(lines)
for line, (ids, begins, end) in zip(lines, got):
    sids, ranges = nat.encode(line)
    assert ids == sids
line_datas = [line.encode() for line in lines]
spans = [(0, len(d)) for d in line_datas]
mat = nv.ingest_lines(
    line_datas, [s[0] for s in spans], [s[1] for s in spans],
    [1] * len(lines), 16, nat.eos_id,
)
raw = nv.ingest_lines(
    line_datas, [s[0] for s in spans], [s[1] for s in spans],
    [1] * len(lines), 16, nat.eos_id, raw=True,
)
assert len(mat) == len(lines) and len(raw) == 7

# padded decode + assemble directly (no jax under ASan: its C++ libs
# throw during import before the interceptor is ready)
import numpy as np

seg_ids, bounds, seg_line, tb, tb_counts, gap, gap_counts = raw
S = len(seg_line)
if S:
    lengths = np.diff(bounds)
    t_pad = int(lengths.max())
    tokens = np.zeros((S, t_pad), np.int32)
    for s in range(S):
        seg = seg_ids[bounds[s] : bounds[s + 1]]
        tokens[s, : len(seg)] = seg  # echo decode
    steps = lengths.astype(np.int32)
    text, text_off, ends, ends_off = nv.decode_padded(tokens, steps)
    n = len(lines)
    src_line_off = np.zeros(n + 1, np.uint64)
    np.cumsum([len(d) for d in line_datas], out=src_line_off[1:])
    src_tb_off = np.zeros(n + 1, np.int64)
    np.cumsum(tb_counts, out=src_tb_off[1:])
    src_gap_off = np.zeros(n + 1, np.int64)
    np.cumsum(gap_counts, out=src_gap_off[1:])
    counts = np.bincount(seg_line, minlength=n).astype(np.int32)
    starts = np.zeros(n, np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    out = native.assemble_lines(
        b"".join(line_datas), src_line_off, tb, src_tb_off, gap,
        src_gap_off, counts, starts,
        np.zeros(S, np.int32), np.arange(S, dtype=np.int32),
        [(text, text_off, ends, ends_off)],
        np.diff(text_off.astype(np.int64)), steps,
    )
    assert out[1][-1] >= 0

# charsmap traversal
from tests.darts import build_charsmap
from slimt_jax.text import spm_proto
from slimt_jax.text.synthetic_vocab import build_spm_model
from slimt_jax.text.vocabulary import Vocabulary
spm = build_spm_model(["hello", "world"])
spm.normalizer.precompiled_charsmap = build_charsmap(
    {"½".encode(): "1/2", b"q": ""}
)
blob = spm_proto.serialize_model(spm)
cs_py = Vocabulary(blob, backend="none")
cs_nat = Vocabulary(blob, backend="native")
for line in ["½ hello q world ½½", "qqq", ""]:
    assert cs_py.encode(line) == cs_nat.encode(line), line
print(f"ASan/UBSan parity OK over {len(lines)} inputs + batch/columnar/charsmap paths")
EOF
LD_PRELOAD="$(g++ -print-file-name=libasan.so)" \
    ASAN_OPTIONS=detect_leaks=0 \
    SLIMT_ROOT="$ROOT" ASAN_LIB="$BUILD/libslimt_host_asan.so" \
    python "$BUILD/check.py"
rm -rf "$BUILD"
