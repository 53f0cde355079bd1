"""Native C++ IO library tests: build it, then check byte-level parity with
the pure-numpy readers on the bundled reference data and random roundtrips."""

import io
import os
import shutil
import subprocess

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def native():
    from fastdnn_tpu.formats import native as nat

    if os.environ.get("FASTDNN_NATIVE", "1") == "0":
        pytest.skip("native IO disabled via FASTDNN_NATIVE=0")
    if not nat.available():
        if shutil.which("g++") is None or shutil.which("make") is None:
            pytest.skip("no native toolchain")
        subprocess.run(["make", "-C", os.path.join(REPO, "native")], check=True)
        nat._lib = None  # force re-probe
        nat._load_failed = False
        assert nat.available()
    return nat


def _numpy_read_features(path):
    from fastdnn_tpu.formats.binary import _Reader

    r = _Reader(open(path, "rb").read())
    n, d = r.read_i32(), r.read_i32()
    return r.read_f32_array(n * d).reshape(n, d)


class TestNativeIO:
    def test_features_parity_with_numpy(self, sample_data, native):
        for f in ["16khz.bin", "8khz.aligned.bin"]:
            p = sample_data[f]
            np.testing.assert_array_equal(native.read_features(p), _numpy_read_features(p))

    def test_model_roundtrip(self, native, tmp_path, rng):
        from fastdnn_tpu.formats import binary

        layers = [
            binary.RawLayer(
                rng.standard_normal((8, 6)).astype(np.float32),
                rng.standard_normal(8).astype(np.float32),
            ),
            binary.RawLayer(
                rng.standard_normal((4, 8)).astype(np.float32),
                rng.standard_normal(4).astype(np.float32),
            ),
        ]
        net = binary.RawNetwork(
            layers,
            rng.standard_normal(6).astype(np.float32),
            rng.standard_normal(6).astype(np.float32),
        )
        p = tmp_path / "m.bin"
        buf = io.BytesIO()
        binary.write_model(net, buf)
        p.write_bytes(buf.getvalue())
        out = native.read_model(p)
        for a, b in zip(net.layers, out.layers):
            np.testing.assert_array_equal(a.weights, b.weights)
            np.testing.assert_array_equal(a.bias, b.bias)
        np.testing.assert_array_equal(net.shift, out.shift)
        np.testing.assert_array_equal(net.scale, out.scale)

    def test_feature_write_read(self, native, tmp_path, rng):
        data = rng.standard_normal((37, 12)).astype(np.float32)
        p = tmp_path / "f.bin"
        native.write_features(data, p)
        np.testing.assert_array_equal(native.read_features(p), data)
        # and numpy can read what native wrote (same format)
        np.testing.assert_array_equal(_numpy_read_features(p), data)

    def test_corrupt_files_rejected(self, native, tmp_path):
        bad = tmp_path / "bad.bin"
        bad.write_bytes(b"\x00\x00")
        with pytest.raises(ValueError):
            native.read_features(bad)
        with pytest.raises(ValueError):
            native.read_model(bad)

    def test_dispatch_through_binary_module(self, sample_data, native):
        """formats.binary transparently uses the native reader for paths."""
        from fastdnn_tpu.formats.binary import read_features

        a = read_features(sample_data["16khz.bin"])
        assert a.shape == (100, 432)


class TestNativeTextFeatures:
    """fd_read_features_text: Kaldi text features parsed natively
    (BatchData.loadMultipleFromText analog, BatchData.java:145-183)."""

    def test_matches_python_parser_on_bundled_data(self, sample_data, native):
        from fastdnn_tpu.formats import kaldi_text

        for name in ("16khz", "8khz"):
            path = sample_data[name]
            got = native.read_features_text(path)
            with open(path) as f:
                ref = kaldi_text.parse_features_text(f.read())
            assert list(got) == list(ref)
            for k in got:
                np.testing.assert_array_equal(got[k], ref[k].astype(np.float32))

    def test_multiple_utterances(self, native, tmp_path):
        p = tmp_path / "feats.txt"
        p.write_text(
            "utt-a  [\n  1.0 2.0 3.0\n  4 5 6 ]\n"
            "utt-b [\n  7.5 -8 9e-1\n  1 2 3\n  4 5 6 ]\n"
        )
        got = native.read_features_text(p)
        assert list(got) == ["utt-a", "utt-b"]
        np.testing.assert_allclose(got["utt-a"], [[1, 2, 3], [4, 5, 6]])
        np.testing.assert_allclose(got["utt-b"], [[7.5, -8, 0.9], [1, 2, 3], [4, 5, 6]])

    def test_ragged_rows_rejected(self, native, tmp_path):
        p = tmp_path / "bad.txt"
        p.write_text("u [\n 1 2 3\n 4 5 ]\n")
        with pytest.raises(ValueError):
            native.read_features_text(p)

    def test_python_fallback_tokenizer_matches_libc_strtof(self):
        """_strtof_py (the no-libc fallback) must agree with ctypes strtof
        token-for-token on representative inputs, including signed
        nan(payload), hex, inf spellings, glued tokens, and whitespace
        skipping (\\v/\\f and even a newline they precede)."""
        import ctypes

        from fastdnn_tpu.formats import kaldi_text as kt

        assert kt._C_STRTOF is not None  # this box has a dlopen-able libc
        samples = [
            "1.5", "-2e-3", "0x10", "-0X1.8p1", "inf", "-Infinity",
            "nan", "-nan", "nan(1)", "-nan(0x1)", "1.5-2", "3.starts",
            "\v\f 7", "\f\n8", "  -0.25junk", "junk", "",
        ]
        for s in samples:
            buf = ctypes.create_string_buffer(s.encode("ascii"))
            endp = ctypes.c_void_p()
            base = ctypes.addressof(buf)
            want_v = kt._C_STRTOF(base, ctypes.byref(endp))
            want_end = (endp.value or base) - base
            got_v, got_end = kt._strtof_py(s, 0)
            assert got_end == want_end, (s, got_end, want_end)
            if want_end:  # a conversion happened: values must match exactly
                want32, got32 = np.float32(want_v), np.float32(got_v)
                if np.isnan(want32):
                    assert np.isnan(got32) and (
                        np.signbit(got32) == np.signbit(want32)
                    ), (s, got_v, want_v)
                else:
                    assert got32 == want32, (s, got_v, want_v)

    def test_strtof_quirk_agreement(self, native, tmp_path):
        """Curated quirky/malformed inputs: the Python mirror and the native
        strtof loop must parse IDENTICALLY or both reject.  Covers the
        strtof corners the well-formed agreement test never hits: \\v/\\f
        whitespace (strtof's own isspace skip — which even splices rows
        when \\f precedes the newline), nan(char-seq), hex and glued
        tokens, ']'-committed and trailing-whitespace-committed final rows,
        and the hard-EOF-after-token rejection."""
        from fastdnn_tpu.formats import kaldi_text

        cases = [
            "u [\n1 2\f\n3 4\n]",     # \f swallows the newline: ONE 4-wide row
            "u [\n1 2\v3\n]",         # \v is token whitespace
            "u [\n1 nan(1) inf -Infinity\n]",
            "u [\n0x10 1.5-2\n]",     # hex + glued tokens -> 16, 1.5, -2
            "u [ 1 2 ]",              # ']' commits the row, no newline needed
            "u [1 2 ",                # EOF through whitespace commits too
            "u [1 2",                 # hard EOF after a token: rejected
            "u [\n1 2\n3\n]",         # ragged: rejected
            "u [\n]",                 # empty block: rejected
            "u [x y]",                # garbage token: rejected
            "u [1 [ 2]",              # '[' inside a block: rejected
            "a [1 2\n] b [3 4\n]",    # positional id/block pairing
        ]
        p = tmp_path / "quirk.txt"
        for text in cases:
            p.write_text(text)
            try:
                want = native.read_features_text(str(p))
            except ValueError:
                with pytest.raises(ValueError):
                    kaldi_text.parse_features_text(text)
                continue
            got = kaldi_text.parse_features_text(text)
            assert list(got) == list(want), text
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=text)

    def test_dispatch_through_kaldi_text_module(self, sample_data, native):
        from fastdnn_tpu.formats.kaldi_text import load_features_text

        feats = load_features_text(sample_data["16khz"])
        assert next(iter(feats.values())).shape == (193, 429)


DATA_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class TestNativeCli:
    """The native fastdnn-io executable (make -C native) — the host-side
    analog of the reference's native CLI (dnn.cc:20-84)."""

    @pytest.fixture(scope="class")
    def cli(self):
        import subprocess

        path = os.path.join(DATA_REPO, "native", "fastdnn-io")
        if not os.path.exists(path):
            r = subprocess.run(["make", "-C", os.path.join(DATA_REPO, "native")],
                               capture_output=True)
            if r.returncode != 0 or not os.path.exists(path):
                pytest.skip("native CLI not built")
        return path

    def test_info_and_finfo(self, sample_data, cli):
        import subprocess

        golden = os.path.join(DATA_REPO, "tests", "golden", "parity_model.bin")
        out = subprocess.run([cli, "info", golden], capture_output=True, text=True)
        assert out.returncode == 0
        assert "topology= 432-64-64-64-100" in out.stdout
        out = subprocess.run([cli, "finfo", sample_data["8khz.aligned.bin"]],
                             capture_output=True, text=True)
        assert "frames = 389" in out.stdout and "dim    = 432" in out.stdout

    def test_text2bin_matches_python(self, sample_data, cli, tmp_path):
        import subprocess

        from fastdnn_tpu.formats.binary import read_features
        from fastdnn_tpu.formats.kaldi_text import first_utterance

        out_bin = tmp_path / "16khz.bin"
        r = subprocess.run([cli, "text2bin", sample_data["16khz"], str(out_bin)],
                           capture_output=True, text=True)
        assert r.returncode == 0, r.stderr
        got = read_features(out_bin)
        ref = first_utterance(sample_data["16khz"]).astype(np.float32)
        np.testing.assert_array_equal(got, ref)

    def test_bad_usage(self, cli):
        import subprocess

        r = subprocess.run([cli], capture_output=True, text=True)
        assert r.returncode == 1 and "usage" in r.stderr
        r = subprocess.run([cli, "info", "/nonexistent"], capture_output=True, text=True)
        assert r.returncode == 2 and "error" in r.stderr


def test_text_parser_truncated_mid_number(native, tmp_path):
    """A file ending mid-number (no ], no newline) must fail cleanly — the
    parser buffer is NUL-terminated so strtof cannot scan off the end."""
    p = tmp_path / "trunc.txt"
    p.write_bytes(b"u [\n 1.0 2.5")
    with pytest.raises(ValueError):
        native.read_features_text(p)


class TestNativeFuzz:
    """Malformed-input fuzz for the C++ parsers (VERDICT r1 #8): random
    truncations and byte corruptions of valid files must produce a clean
    Python-level error or a successful parse — never a crash (a segfault
    would kill this pytest process, which is the detector)."""

    @pytest.fixture(scope="class")
    def model_bytes(self, tmp_path_factory):
        import jax

        from fastdnn_tpu.formats.binary import write_model
        from fastdnn_tpu.models.feedforward import random_net, to_raw

        p = tmp_path_factory.mktemp("fuzz") / "m.bin"
        write_model(to_raw(random_net(jax.random.PRNGKey(2), 24, [32, 32], 40)), p)
        return p.read_bytes()

    def _fuzz(self, native, tmp_path, data: bytes, parse, n_trials=60):
        rng = np.random.default_rng(0)
        path = tmp_path / "fuzzed.bin"
        outcomes = {"ok": 0, "rejected": 0}
        for t in range(n_trials):
            buf = bytearray(data)
            if t % 2 == 0:  # truncation (incl. mid-header, mid-row)
                cut = int(rng.integers(0, len(buf)))
                buf = buf[:cut]
            else:  # corruption: flip a few bytes (headers get huge dims)
                for _ in range(int(rng.integers(1, 6))):
                    buf[int(rng.integers(0, len(buf)))] = int(rng.integers(0, 256))
            path.write_bytes(bytes(buf))
            try:
                parse(str(path))
                outcomes["ok"] += 1
            except (ValueError, MemoryError):
                outcomes["rejected"] += 1
        # most mutations must be cleanly rejected (not silently accepted)
        assert outcomes["rejected"] > n_trials // 4, outcomes

    def test_model_parser_fuzz(self, native, tmp_path, model_bytes):
        self._fuzz(native, tmp_path, model_bytes, native.read_model)

    def test_feature_parser_fuzz(self, sample_data, native, tmp_path):
        data = open(sample_data["8khz.aligned.bin"], "rb").read()
        self._fuzz(native, tmp_path, data, native.read_features)

    def test_text_feature_parser_fuzz(self, sample_data, native, tmp_path):
        """Truncation/corruption fuzz: the native parser must never crash,
        and the mirroring Python parser must AGREE on every fuzzed file —
        identical utterances/matrices on accept, rejection on reject (the
        statement-for-statement mirror makes full agreement assertable,
        not just crash-freedom)."""
        from fastdnn_tpu.formats import kaldi_text

        data = open(sample_data["16khz"], "rb").read()

        rng = np.random.default_rng(1)
        path = tmp_path / "fuzzed.txt"
        for t in range(40):
            buf = bytearray(data)
            if t % 2 == 0:
                buf = buf[: int(rng.integers(0, len(buf)))]
            else:
                for _ in range(int(rng.integers(1, 8))):
                    buf[int(rng.integers(0, len(buf)))] = int(rng.integers(32, 127))
            path.write_bytes(bytes(buf))
            text = bytes(buf).decode("ascii", "replace")
            try:
                want = native.read_features_text(str(path))
            except ValueError:
                with pytest.raises(ValueError):
                    kaldi_text.parse_features_text(text)
                continue
            got = kaldi_text.parse_features_text(text)
            assert list(got) == list(want), f"trial {t}"
            for k in want:  # parsed data must be well-formed AND identical
                assert want[k].ndim == 2
                np.testing.assert_array_equal(got[k], want[k], err_msg=f"trial {t}/{k}")


def test_native_score_via_server(tmp_path):
    """fastdnn-io score — scoring END TO END from pure native code: the C++
    CLI reads the feature file, speaks the FDN1 wire protocol to a running
    server, and writes the posteriors in the reference binary format.  The
    reference capability this covers is its only executable's job
    (dnn.cc:20-84), with the DNN math on the accelerator behind the socket."""
    import subprocess
    import threading

    import jax

    from fastdnn_tpu.cli.serve import ScoreServer
    from fastdnn_tpu.config import EngineConfig
    from fastdnn_tpu.engine.scorer import Scorer
    from fastdnn_tpu.engine.stream import StreamingScorer
    from fastdnn_tpu.formats.binary import read_features, write_features
    from fastdnn_tpu.models.feedforward import align, random_net
    from fastdnn_tpu.quant.quantize import quantize_net

    cli = os.path.join(REPO, "native", "fastdnn-io")
    if not os.path.exists(cli):
        r = subprocess.run(["make", "-C", os.path.join(REPO, "native")], capture_output=True)
        if r.returncode != 0 or not os.path.exists(cli):
            pytest.skip("native CLI not built")

    net = align(random_net(jax.random.PRNGKey(4), 429, [64, 64], 80), 4, 16)
    scorer = Scorer(quantize_net(net), EngineConfig(backend="xla"))
    stream = StreamingScorer(scorer, max_batch_frames=256)
    server = ScoreServer(("127.0.0.1", 0), stream)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        frames = np.random.default_rng(0).standard_normal((23, 432)).astype(np.float32)
        fpath, opath = tmp_path / "f.bin", tmp_path / "p.bin"
        write_features(frames, fpath)
        host, port = server.server_address[:2]
        r = subprocess.run(
            [cli, "score", f"{host}:{port}", str(fpath), str(opath), "BIN"],
            capture_output=True, text=True, timeout=120,
        )
        assert r.returncode == 0, r.stderr
        got = read_features(opath)
        np.testing.assert_allclose(got, scorer.score(frames), atol=1e-6)
        # bad address errors cleanly
        r = subprocess.run([cli, "score", "127.0.0.1:1", str(fpath)],
                           capture_output=True, text=True, timeout=60)
        assert r.returncode == 2 and "error" in r.stderr
    finally:
        server.shutdown()
        stream.close()


class TestParserAgreement:
    """The Python fallback parser mirrors the STRICT native parser: on any
    input — well-formed or malformed — the two either parse identically or
    both raise ValueError.  This makes the fallback path (taken exactly when
    the native parser rejects a file, kaldi_text.load_features_text) unable
    to silently mispair ids and blocks the way the reference's own
    zip-of-two-regexes Java parser can (BatchData.java:140-160)."""

    CASES = [
        # well-formed
        b"utt-a  [\n  1.0 2.0 3.0\n  4 5 6 ]\nutt-b [\n 7.5 -8 9e-1 ]\n",
        # truncated mid-row at EOF: native never commits the partial row
        b"u [\n 1.0 2.5",
        # EOF right after a newline-terminated row: accepted without ']'
        b"u [\n1 2\n",
        b"u [\n1 2\n3 4\n",
        # trailing id with no block is dropped
        b"u [1 2]\ntrailer-no-block",
        # block with empty id
        b"[1 2]\n",
        # '[' inside a block
        b"u [1 2 [ 3]",
        # ragged rows
        b"u [\n1 2 3\n4 5 ]\n",
        # empty / whitespace-only block
        b"u [ ]\n",
        b"u [\n\n]\n",
        # strtof tokenization: adjacent sign splits, hex, inf/nan
        b"u [1.5-2 3]\n",
        b"u [0x10 2]\n",
        b"u [nan inf -inf]\n",
        # invalid exponent: strtof backs off to "1", then 'e' fails
        b"u [1e 2]\n",
        # stray ']' between utterances becomes (both parsers) the next id
        b"a [1 2] ] b [3 4]\n",
        # extra tokens between id and '[' are ignored
        b"a  extra junk [1 2]\n",
        # no utterances at all
        b"just some text, no blocks",
        b"",
        b"lonely-id-no-bracket",
    ]

    def _run_both(self, native, tmp_path, raw: bytes):
        from fastdnn_tpu.formats import kaldi_text

        p = tmp_path / "case.txt"
        p.write_bytes(raw)
        try:
            n_out = native.read_features_text(str(p))
        except ValueError:
            n_out = None
        try:
            p_out = kaldi_text.parse_features_text(raw.decode("ascii"))
        except ValueError:
            p_out = None
        return n_out, p_out

    @pytest.mark.parametrize("raw", CASES, ids=range(len(CASES)))
    def test_curated_malformed_agreement(self, native, tmp_path, raw):
        n_out, p_out = self._run_both(native, tmp_path, raw)
        assert (n_out is None) == (p_out is None), (
            f"one parser rejected what the other accepted: "
            f"native={n_out is not None} python={p_out is not None}"
        )
        if n_out is not None:
            assert list(n_out) == list(p_out)
            for k in n_out:
                np.testing.assert_array_equal(n_out[k], p_out[k])

    def test_mutation_fuzz_agreement(self, sample_data, native, tmp_path):
        """Random byte mutations/truncations of the bundled text features:
        both parsers must keep agreeing (parse-equal or both-reject)."""
        data = open(sample_data["16khz"], "rb").read()
        rng = np.random.default_rng(7)
        agreements = {"both_ok": 0, "both_reject": 0}
        for t in range(24):
            buf = bytearray(data)
            if t % 2 == 0:
                buf = buf[: int(rng.integers(1, len(buf)))]
            for _ in range(int(rng.integers(0, 6))):
                buf[int(rng.integers(0, len(buf)))] = int(rng.integers(32, 127))
            n_out, p_out = self._run_both(native, tmp_path, bytes(buf))
            assert (n_out is None) == (p_out is None), f"trial {t} disagreed"
            if n_out is None:
                agreements["both_reject"] += 1
            else:
                agreements["both_ok"] += 1
                assert list(n_out) == list(p_out), f"trial {t} key order"
                for k in n_out:
                    np.testing.assert_array_equal(n_out[k], p_out[k])
        # the sweep must exercise both outcomes to mean anything
        assert agreements["both_ok"] > 0 and agreements["both_reject"] > 0, agreements
