"""Worker for the true multi-process (multi-"host") test.

Launched once per process by tests/test_multihost.py:

    python tests/multihost_worker.py COORD_ADDR NUM_PROCS PROC_ID OUT_DIR

Each process owns 4 virtual CPU devices; jax.distributed.initialize wires
them into one 8-device global mesh (2 "hosts" x 4 devices — the DP axis
spans processes like a network between hosts would, the model axis stays
process-local like the cards of one host).  Every process feeds its local shard of a deterministic frame batch
through the GSPMD scorer; process 0 writes the gathered posteriors for the
driver test to compare against the single-process engine.
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=4").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def serve_mode(num: int, pid: int, out_dir: str) -> int:
    """End-to-end multi-host SERVING: process 0 runs the TCP score server
    over a MultiHostScorer (StreamingScorer batching on top), scores
    utterances through a real socket client, and saves the results;
    process 1 runs the scoring worker loop.  The driver test compares the
    saved posteriors against the single-process engine."""
    import numpy as np

    from fastdnn_tpu.config import EngineConfig
    from fastdnn_tpu.models.feedforward import random_net
    from fastdnn_tpu.parallel.mesh import make_mesh
    from fastdnn_tpu.parallel.service import MultiHostScorer
    from fastdnn_tpu.quant.quantize import quantize_net

    net = random_net(jax.random.PRNGKey(5), 32, [64, 64], 32)
    qnet = quantize_net(net)
    mesh = make_mesh(model=2)  # (data=4, model=2) across the 2 processes
    scorer = MultiHostScorer(qnet, EngineConfig(backend="xla"), mesh, heartbeat_s=0.5)

    if pid != 0:
        scorer.worker_loop()
        return 0

    import threading

    from fastdnn_tpu.cli.serve import ScoreClient, ScoreServer
    from fastdnn_tpu.engine.stream import StreamingScorer

    stream = StreamingScorer(scorer, max_batch_frames=256, max_wait_ms=2.0)
    server = ScoreServer(("127.0.0.1", 0), stream)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        rng = np.random.default_rng(7)
        client = ScoreClient(*server.server_address[:2])
        utts = [rng.standard_normal((n, 32)).astype(np.float32) for n in (9, 17, 5)]
        posts = [client.score(u) for u in utts]
        masks = (rng.random((utts[0].shape[0], scorer.output_dim)) < 0.5).astype(np.uint8)
        post_masked = client.score(utts[0], masks)
        stats = client.stats()
        assert stats["output_dim"] == scorer.output_dim
        client.close()
        np.savez(
            os.path.join(out_dir, "serve_posteriors.npz"),
            *posts,
            masked=post_masked,
            frames0=utts[0], frames1=utts[1], frames2=utts[2], masks=masks,
        )
    finally:
        server.shutdown()
        stream.close()
        scorer.close()
    return 0


def main() -> int:
    coord, num, pid, out_dir = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    mode = sys.argv[5] if len(sys.argv) > 5 else "gspmd"
    from fastdnn_tpu.parallel.mesh import init_multihost

    init_multihost(coord, num_processes=num, process_id=pid)
    assert jax.process_count() == num, jax.process_count()
    devices = jax.devices()
    assert len(devices) == jax.local_device_count() * num, len(devices)

    if mode == "serve":
        return serve_mode(num, pid, out_dir)

    if mode == "kv-timeout":
        # ADVICE r4 (medium): pin the retry classifier against the REAL
        # exception the coordination service raises on a blocking KV get
        # expiry — _recv_global's wait-forever loop retries exactly the
        # exceptions _is_kv_timeout accepts, so the classifier must match
        # what this jaxlib actually throws (and must NOT match a plain
        # wrong-key/unavailable error, tested separately below).
        from fastdnn_tpu.parallel.service import _is_kv_timeout, _kv_client

        client = _kv_client()
        assert client is not None, "no KV client under jax.distributed"
        try:
            client.blocking_key_value_get_bytes(
                f"fastdnn/test/never-set-key/{pid}", 300
            )
        except Exception as e:
            assert _is_kv_timeout(e), (
                f"KV expiry not classified as timeout: {type(e).__name__}: {e}"
            )
        else:
            print("FATAL: blocking get of a never-set key returned")
            return 3
        # a non-timeout error must NOT be classified as retryable
        assert not _is_kv_timeout(RuntimeError("UNAVAILABLE: coordinator gone"))
        if pid == 0:
            with open(os.path.join(out_dir, "kv_timeout_ok"), "w") as f:
                f.write("ok")
        return 0

    if mode == "worker-death":
        # failure-detection test: the worker crashes after one successful
        # scoring op; the coordinator's call_timeout_s watchdog must surface
        # a clean error (not a silent hang) and subsequent calls fail fast
        import numpy as np

        from fastdnn_tpu.config import EngineConfig
        from fastdnn_tpu.models.feedforward import random_net
        from fastdnn_tpu.parallel.mesh import make_mesh
        from fastdnn_tpu.parallel.service import MultiHostScorer
        from fastdnn_tpu.quant.quantize import quantize_net

        qnet = quantize_net(random_net(jax.random.PRNGKey(5), 32, [64, 64], 32))
        mesh = make_mesh(model=2)
        sc = MultiHostScorer(qnet, EngineConfig(backend="xla"), mesh,
                             heartbeat_s=0, call_timeout_s=15.0)
        frames = np.random.default_rng(7).standard_normal((16, 32)).astype(np.float32)
        if pid != 0:
            orig = sc._replicate

            def replicate_then_die(x):
                out = orig(x)
                out.block_until_ready()
                os._exit(17)  # crash WITHOUT the stop op (simulated death)

            sc._replicate = replicate_then_die
            sc.worker_loop()
            return 0

        post = sc.score(frames)  # both processes alive: must succeed
        assert post.shape == (16, qnet.output_dim)
        import time

        time.sleep(1.5)  # let the worker finish dying
        try:
            sc.score(frames)
            print("FATAL: dead worker not detected")
            return 3
        except Exception as e:
            print(f"death surfaced: {type(e).__name__}: {e}")
        try:
            sc.score(frames)  # scorer closed itself: must fail FAST now
            print("FATAL: closed scorer accepted a call")
            return 4
        except RuntimeError:
            pass
        with open(os.path.join(out_dir, "death_ok"), "w") as f:
            f.write("ok")
        sys.stdout.flush()
        # the pod is known-dead: jax.distributed's atexit shutdown barrier
        # would fail against the crashed worker and dirty the exit code —
        # hard-exit (a supervisor would restart all processes here anyway)
        os._exit(0)

    if mode == "churn4":
        # 4-process pod (VERDICT r4 #7): scatter distribution + watchdog
        # under real process churn.  Three scoring calls stream through the
        # KV-scatter path with all 4 processes alive; then worker 3 crashes
        # WITHOUT the stop op and the coordinator's watchdog must declare
        # the pod dead and fail fast afterwards.
        import numpy as np

        from fastdnn_tpu.config import EngineConfig
        from fastdnn_tpu.models.feedforward import random_net
        from fastdnn_tpu.parallel.mesh import make_mesh
        from fastdnn_tpu.parallel.service import MultiHostScorer
        from fastdnn_tpu.quant.quantize import quantize_net

        qnet = quantize_net(random_net(jax.random.PRNGKey(5), 32, [64, 64], 32))
        mesh = make_mesh(model=2)  # (data, model=2) over all devices
        sc = MultiHostScorer(qnet, EngineConfig(backend="xla"), mesh,
                             heartbeat_s=0, call_timeout_s=20.0)
        # the whole point of a 4-proc pod is the scatter path: pin that the
        # KV client resolved (a None here silently demotes to broadcast)
        assert sc._scatter, "KV scatter unavailable in a real 4-process pod"
        rng = np.random.default_rng(7)
        batches = [rng.standard_normal((16, 32)).astype(np.float32)
                   for _ in range(3)]
        masks = (rng.random((16, qnet.output_dim)) < 0.4).astype(np.uint8)

        if pid == 3:
            calls = [0]
            orig = sc._replicate

            def replicate_then_die(x):
                out = orig(x)
                out.block_until_ready()
                calls[0] += 1
                if calls[0] >= 4:  # 3 scores + 1 masked, then churn
                    os._exit(17)
                return out

            sc._replicate = replicate_then_die
            sc.worker_loop()
            return 0
        if pid != 0:
            # workers 1/2 survive the churn but are wedged in the dead
            # pod's collectives afterwards (the runtime cannot cancel
            # them) — exactly the "restart all processes" contract.  Run
            # the loop in a daemon thread and exit once the coordinator
            # has proven the failure was detected (marker file).
            import threading
            import time

            t = threading.Thread(target=sc.worker_loop, daemon=True)
            t.start()
            deadline = time.time() + 120
            marker = os.path.join(out_dir, "churn4_ok")
            while time.time() < deadline:
                if os.path.exists(marker):
                    os._exit(0)  # supervisor-restart analog
                if not t.is_alive():
                    return 0  # clean stop op (not expected in this mode)
                time.sleep(0.25)
            print("FATAL: coordinator never wrote the churn4_ok marker")
            os._exit(5)

        for b in batches:
            post = sc.score(b)
            assert post.shape == (16, qnet.output_dim)
        post_m = sc.score_masked(batches[0], masks)
        assert post_m.shape == (16, qnet.output_dim)
        np.savez(os.path.join(out_dir, "churn4.npz"),
                 post=post, post_m=post_m, frames=batches[-1], masks=masks)
        import time

        time.sleep(1.5)  # let worker 3 finish dying
        try:
            sc.score(batches[0])
            print("FATAL: dead worker not detected")
            return 3
        except Exception as e:
            print(f"churn surfaced: {type(e).__name__}")
        try:
            sc.score(batches[0])
            print("FATAL: closed scorer accepted a call")
            return 4
        except RuntimeError:
            pass
        with open(os.path.join(out_dir, "churn4_ok"), "w") as f:
            f.write("ok")
        sys.stdout.flush()
        os._exit(0)  # known-dead pod: skip the atexit shutdown barrier

    if mode == "lazy":
        # multi-process LazyContext (VERDICT r3 #7): the coordinator-side
        # shim routes each per-frame masked call through the coordinated
        # score_masked program; workers just run worker_loop unchanged
        import numpy as np

        from fastdnn_tpu.config import EngineConfig
        from fastdnn_tpu.models.feedforward import random_net
        from fastdnn_tpu.parallel.mesh import make_mesh
        from fastdnn_tpu.parallel.service import MultiHostScorer
        from fastdnn_tpu.quant.quantize import quantize_net

        qnet = quantize_net(random_net(jax.random.PRNGKey(5), 32, [64, 64], 32))
        mesh = make_mesh(model=2)
        sc = MultiHostScorer(qnet, EngineConfig(backend="xla"), mesh,
                             heartbeat_s=0.5)
        if pid != 0:
            sc.worker_loop()
            return 0
        n = 5
        frames = np.random.default_rng(7).standard_normal((n, 32)).astype(np.float32)
        masks = (np.random.default_rng(9).random((n, 32)) < 0.5).astype(np.uint8)
        masks[:, 0] = 1  # at least one active senone per frame
        ctx = sc.new_lazy_context(n)
        ctx.calculate_until_output(frames)
        posts = np.stack([ctx.calculate_for_output_nodes(masks[i]) for i in range(n)])
        np.savez(os.path.join(out_dir, "lazy_mh.npz"),
                 posts=posts, frames=frames, masks=masks)
        sc.close()
        return 0

    if mode == "tp-across":
        # model axis spanning BOTH processes: the sharded softmax's
        # pmax/psum collectives cross the process boundary (DCN-like),
        # unlike the default mode where model pairs stay intra-process
        import numpy as np

        from fastdnn_tpu.config import EngineConfig
        from fastdnn_tpu.models.feedforward import random_net
        from fastdnn_tpu.parallel.mesh import make_mesh
        from fastdnn_tpu.parallel.service import MultiHostScorer
        from fastdnn_tpu.quant.quantize import quantize_net

        net = random_net(jax.random.PRNGKey(5), 32, [64, 64], 64)
        qnet = quantize_net(net)
        mesh = make_mesh(model=len(devices))  # (data=1, model=8): all-TP
        # scatter=False: keeps the full-broadcast fallback path covered
        # (serve/worker-death modes cover the default scatter path)
        sc = MultiHostScorer(qnet, EngineConfig(backend="xla"), mesh,
                             heartbeat_s=0.5, scatter=False)
        if pid != 0:
            sc.worker_loop()
            return 0
        frames = np.random.default_rng(7).standard_normal((24, 32)).astype(np.float32)
        masks = (np.random.default_rng(9).random((24, 64)) < 0.4).astype(np.uint8)
        post = sc.score(frames)
        post_m = sc.score_masked(frames, masks)
        np.savez(os.path.join(out_dir, "tp_across.npz"),
                 post=post, post_m=post_m, frames=frames, masks=masks)
        sc.close()
        return 0

    import numpy as np

    from fastdnn_tpu.models.feedforward import random_net
    from fastdnn_tpu.parallel.mesh import make_mesh
    from fastdnn_tpu.parallel.sharded import make_gspmd_scorer
    from fastdnn_tpu.quant.quantize import quantize_net
    from jax.sharding import NamedSharding, PartitionSpec as P

    # identical model + frames in every process (deterministic seeds)
    net = random_net(jax.random.PRNGKey(5), 32, [64, 64], 4 * len(devices))
    qnet = quantize_net(net)
    B = 64
    frames = np.random.default_rng(7).standard_normal((B, 32)).astype(np.float32)

    mesh = make_mesh(model=2)  # (data=4, model=2) over 8 global devices
    score, _ = make_gspmd_scorer(mesh, out_dim=qnet.output_dim)

    # build the globally-sharded frame array from per-process local shards:
    # mesh device order follows process order, so process p owns the data
    # rows [p*B/num, (p+1)*B/num)
    sharding = NamedSharding(mesh, P("data", None))
    local = frames[pid * (B // num) : (pid + 1) * (B // num)]
    global_frames = jax.make_array_from_process_local_data(
        sharding, local, global_shape=(B, frames.shape[1])
    )

    post = score(qnet, global_frames)
    # gather to every process for the check
    gathered = np.asarray(
        jax.jit(lambda x: x, out_shardings=NamedSharding(mesh, P()))(post)
    )
    if pid == 0:
        np.save(os.path.join(out_dir, "multihost_post.npy"), gathered)
    return 0


if __name__ == "__main__":
    sys.exit(main())
