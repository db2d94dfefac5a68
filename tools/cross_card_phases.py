#!/usr/bin/env python3
"""Run chip_smoke.py's multi-rank phases alone, on a card per rank.

Run from the root of a checkout on a machine with four CUDA cards:
    python3 tools/cross_card_phases.py [PHASE ...]

Drives the context-parallel LM ring (``chip_smoke.run_ring``: 4 ranks,
B 1 x L 16384) and the VGG parts (``chip_smoke.run_vgg``: world 1, 2 and
4) with their own gates: launch counts, ranks bit for bit equal, one step
kernel path vs plain path, losses.  Then the real commands, one process
per rank: ``cli.lm --parallel ring`` at world 2 (``chip_smoke.run_ring_cli``),
``cli.part3 --ring-compress int8`` at world 2 (``chip_smoke.run_vgg_cli``)
and ``cli.lm --parallel dp --num-nodes 4`` at the LM's full width
(``run_dp_cli`` below); each must exit 0 on every rank, print the
reference's protocol lines and name nccl in its banner.  The serving
fleet's run (a) (``run_fleet`` below): ``chip_smoke.serve_fleet``'s
steady run with replica r's engine and models on ``cuda:r``.  With a card per
rank the ranks choose nccl (``runtime/distributed.plan_placement``); on
one card they share it over gloo, as ``chip_smoke.py`` runs them.  Prints
each kernel's launches over the spawned phases (the codec's by chunk length
and residual); exits 1 if a phase fails.
PHASE names limit the run to those phases (``ring``, ``vgg``, ``ring cli``,
``vgg cli``, ``dp cli``, ``fleet``), e.g. the VGG ones alone after a change to the
int8 ring codec.
"""

import os
import socket
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# cli.lm --parallel dp across DP_CLI["world"] processes: the LM at full
# width (chip_smoke.MODEL), B 8 x L 4096 split over the ranks, 5 steps.
DP_CLI = dict(world=4, seq_len=4096, batch_size=8, max_iters=5)


def run_dp_cli(smoke, backend: str) -> None:
    """``python -m ...cli.lm --parallel dp --num-nodes W --master-ip --rank``
    in W processes; every process exits 0, and rank 0's banner names the
    world, the attention kernel and ``backend``, followed by the reference's
    timing lines."""
    with socket.socket() as sock:  # a free port for the rendezvous
        sock.settimeout(10)
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    world, m = DP_CLI["world"], smoke.MODEL
    cmd = [sys.executable, "-m", "distributed_machine_learning_tpu_torch.cli.lm",
           "--parallel", "dp", "--num-nodes", str(world), "--master-ip", f"127.0.0.1:{port}",
           "--d-model", str(m["d_model"]), "--n-layers", str(m["n_layers"]),
           "--n-heads", str(m["n_heads"]), "--n-kv-heads", str(m["n_kv_heads"]),
           "--vocab", str(m["vocab_size"]), "--seq-len", str(DP_CLI["seq_len"]),
           "--batch-size", str(DP_CLI["batch_size"]), "--max-iters", str(DP_CLI["max_iters"]),
           "--compute-dtype", "bfloat16", "--optimizer", "adamw", "--fused-update",
           "--attn", "flash"]
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    t0 = time.perf_counter()
    procs = [subprocess.Popen([*cmd, "--rank", str(r)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env)
             for r in range(world)]
    try:
        outs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    rcs = [p.returncode for p in procs]
    lines = [ln for ln in outs[0].splitlines()
             if ln.startswith(("lm parallel=", "Total execution", "Average execution"))]
    smoke.log(f"cli.lm --parallel dp, {world} processes ({time.perf_counter() - t0:.1f} s): "
              f"exit codes {rcs}; rank 0: {lines}")
    want = (f"lm parallel=dp devices={world}", "Total execution time is",
            "Average execution time is")
    if rcs != [0] * world or not all(any(ln.startswith(w) for ln in lines) for w in want) \
            or "attn=flash" not in lines[0] or f"backend={backend}" not in lines[0]:
        raise AssertionError(f"cli.lm dp: exit codes {rcs}; output tails "
                             f"{[o[-2000:] for o in outs]}")


def run_fleet(smoke, torch, card: str) -> None:
    """``chip_smoke.fleet_run``'s run (a) with a card per replica: the LM at
    full width (bf16, the seed's weights) copied to ``cuda:r`` for replica
    r with its own int8 twin and pool; 2 live and 1 spare, FLEET_REQUESTS
    requests, the latency lever.  Gates: exactly once with no eviction,
    every request well formed, first tokens against the plain path, K1 and
    K5 launched.
    Reports tokens/s beside one engine's drain of the same requests on
    ``cuda:0``."""
    import copy

    import distributed_machine_learning_tpu_torch as pkg
    from distributed_machine_learning_tpu_torch.ops import build

    world = smoke.FLEET["replicas"] + smoke.FLEET["spares"]
    models, _ = smoke.make_models(torch, pkg)
    base = models.pop("bf16")
    del models
    engines = []
    for r in range(world):
        model = base if r == 0 else copy.deepcopy(base).to(f"cuda:{r}")
        with torch.cuda.device(r):
            engines += smoke.fleet_engines(torch, model, 1)
    prompts, news = smoke.engine_traffic(torch, smoke.FLEET_REQUESTS)
    lone, seconds = smoke.drain_engine(torch, engines[0], prompts, news)
    smoke.log(f"fleet, a card per replica: one engine's drain of the same requests on "
              f"cuda:0 [{card}]: {seconds:.3f} s -> {sum(news) / seconds:.1f} generated tok/s")
    build.reset_launch_counts()
    a = smoke.fleet_run(torch, engines, prompts, news)
    launches = dict(build.launches)
    smoke.log_fleet_run("a, a card per replica", a, news, card)
    smoke.log(f"fleet run (a), a card per replica: launches {launches}")
    v = a["verdict"]
    if not (v["exactly_once"] and v["admitted"] == v["completed"] == smoke.FLEET_REQUESTS
            and v["evictions"] == 0):
        raise AssertionError(f"fleet, a card per replica: not exactly once, or an eviction: {v}")
    for name in ("flash_fwd", "paged_attention"):
        if launches[name] == 0:
            raise AssertionError(f"fleet, a card per replica: {name} never launched")
    smoke.check_completions(a["done"], prompts, news, "fleet, a card per replica")
    same = sum(a["done"][i]["tokens"] == lone[i]["tokens"] for i in range(len(prompts)))
    smoke.log(f"fleet, a card per replica vs the lone engine: {same}/{len(prompts)} "
              f"requests equal token for token")
    smoke.check_first_tokens(torch, engines[0], a["done"], prompts,
                             "fleet, a card per replica")


if __name__ == "__main__":  # the phases spawn ranks that import this module
    import torch

    import chip_smoke as smoke
    from distributed_machine_learning_tpu_torch.ops import build

    if not torch.cuda.is_available():
        print("cross_card_phases: no CUDA device", file=sys.stderr)
        sys.exit(2)
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 references stay f32
    torch.backends.cudnn.allow_tf32 = False
    cards = torch.cuda.device_count()
    card = smoke.card_line()
    print(f"card: {card}; {cards} cards", flush=True)
    build.build_all()
    rows = {name: {} for name in build.KERNELS}
    rows.update({smoke.codec_row(k, n, r): {} for k in smoke.CODEC_KERNELS
                 for n in smoke.CODEC_PATH_LENGTHS for r in (True, False)
                 if r or k == "ring_encode_int8"})  # the codec's launches by row
    rows.update({smoke.codec_row("ring_decode_int8", n, rows=w): {}
                 for w, n in smoke.CODEC_ALLGATHER})  # the all-gather's batched K10
    backend = "nccl" if cards >= DP_CLI["world"] else "gloo"
    phases = [("ring", lambda: smoke.run_ring(torch, rows)),
              ("vgg", lambda: smoke.run_vgg(torch, rows)),
              ("ring cli", lambda: smoke.run_ring_cli(torch, backend)),
              ("vgg cli", lambda: smoke.run_vgg_cli(torch, backend)),
              ("dp cli", lambda: run_dp_cli(smoke, backend)),
              ("fleet", lambda: run_fleet(smoke, torch, card))]
    chosen = sys.argv[1:] or [name for name, _ in phases]
    unknown = set(chosen) - {name for name, _ in phases}
    if unknown:
        print(f"cross_card_phases: unknown phases {sorted(unknown)}", file=sys.stderr)
        sys.exit(2)
    phases = [(name, phase) for name, phase in phases if name in chosen]
    failed = []
    for name, phase in phases:
        t0 = time.perf_counter()
        try:
            phase()
        except AssertionError as exc:
            failed.append(f"{name}: {exc}")
        print(f"{name} phase: {time.perf_counter() - t0:.1f} s", flush=True)
    print({name: (row.get("ring_launches"), row.get("vgg_launches"))
           for name, row in rows.items()}, flush=True)
    if failed:
        print(f"FAILED: {failed}", flush=True)
        sys.exit(1)
