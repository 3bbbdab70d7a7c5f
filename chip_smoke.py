#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ahrag_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels (``ahrag_tpu_torch/ops/csrc``) and its C++
featurizer (``ahrag_tpu_torch/native/csrc``) and then, in phases that each
print their wall time:

  1. builds the kernels (one nvcc call) and then the native featurizer (the
     host C++ compiler), printing the seconds of each; prints ptxas's
     registers and spills per kernel, each block's dynamic shared memory at
     the main-path shapes and, from ``cuobjdump -sass``, each kernel's HGMMA
     and FFMA counts, and fails unless every bf16 instantiation of
     ``ahrag_binmax2``, ``ahrag_binmax`` and ``ahrag_tile_topk`` runs HGMMA
     (wgmma);
  2. holds each kernel against its plain PyTorch version on the card: the
     bin-max kernels in bf16 and float32, masked and trivial, D = 384, 6
     tiles, n_valid short of N, one fully masked tile, ``dense_binmax2`` at
     B 128/512 on exact inputs (equal bins) and unit vectors, with a
     bf16-rounding control that must fail the limit, and on exact inputs at
     D = 200 (a partial 64-element box) and 768 (32-query chunks in bf16);
     ``dense_binmax`` on unit vectors at B 1/4/5/16/20/64/100/128/200 (with its
     own bf16-rounding control) and on exact inputs (equal bins) over both
     types, B 1/4/5/16/20/64/100/128/200 (every query chunk), tile_n 1024 and
     4096, D 200/384/768, n_valid short of N and one fully masked tile;
     the tile top-k kernel over both types, tile_n 256/512/1024,
     B 1/5/128, k 1/5/10 and k = tile_n (B 5 and 128), a partial n_valid, a
     random mask with one fully masked tile, on exact inputs (ids and values
     equal) and on unit vectors, with a control that rounds the plain scores
     to bf16 and must fail the limit, the all-identical-rows tie case, and
     exact inputs at D = 200, at D = 768 in bf16 and at tile_n = 2048 (the
     last two on 16-query chunks);
  3. the 1,048,576-entity bench rung (1,067,008 nodes, bf16, B = 512) through
     ``hybrid_search_batch``: rank parity against the CPU reference on 8
     queries, the certificate audit on 64, the certified share, the kernels'
     launch counts and the batch time over 12 varied batches;
  4. the 131,072-entity rung in float32 with B = 2048, the same checks;
  5. flat exact top-k: ``dense_topk`` (k = 5) over the 1M rung's corpus at
     B = 512 and over the 131k rung's at B = 2048, held against
     ``dense_topk_ref`` on the card, with batch time and qps over 12 varied
     batches, the kernel's time (also at k = 1), its plain version's and the
     library's;
  6. serving: 4 text queries, then the first 256 sample questions at buckets
     4, 16, 64 and 256 through ``pack_queries`` (native featurizer, held bit
     for bit against the Python one, both timed), and ``encode_and_search``
     against the 1M-node graph, the card's ids held against the CPU's;
  7. encoding: ``encode_device`` of the sample corpus with an IDF from
     ``document_frequencies``, on the card and on the CPU;
  8. a host graph: the sample corpus's 4,050 lines as entities under topic
     summaries and communities (4,122 nodes, n_pad 5,120), built, indexed
     (``build_vector_index``: IDF, associations, LSA), saved and loaded as a
     ``HierarchicalGraph`` on the card and served by a ``RetrievalService``:
     64 and 256 sample questions through ``search_many`` (``dense_binmax`` at
     bucket 64, ``dense_binmax2`` at 256) against the same service on the
     CPU and against ``hg.search``, then ``serve_http`` on port 0 (/healthz,
     /search with one and three queries, /beam, /answer for two sample
     questions, each equal to ``svc.answer``, /stats);
  9. the service at 1M nodes: phase 3's bf16 tensors behind a
     ``RetrievalService(max_batch=512, max_wait_s=0.003)`` with a lazily
     built node table, ``run_load`` at 1, 32 and 256 closed-loop callers x 16
     requests (qps, p50/p95/p99/max, mean batch, errors, stage timers), the
     ids of 4 texts against a direct ``pack_queries`` + ``encode_and_search``,
     and a ``torch.profiler`` trace of 8 batches at bucket 256 (its ten ops
     with the most device time; the trace goes to
     ``traces/serve_1m/``);
 10. the agent at 1M nodes (phase 3's tensors, max_steps 6): ``rollout_batch``
     at B = 512 (``dense_binmax2``) and 16 (``dense_binmax``) with the
     full-width ``ActorCritic`` and with the random policy, checked (no
     masked action taken, logps and values against a direct forward, first
     steps live) and timed (``env_reset``, ``env_step``, ``observe``, the
     rollout, episodes/s); a scripted policy on 64 lanes on the card and on
     phase 6's CPU tensors (actions, rewards, dones, masks and the final
     state equal, observations within 1e-5); ``env_reset``'s anchors
     against certified ``hybrid_search_batch`` at B = 512; related and LCA
     steps on a 4,584-node graph with hyperedges, card against CPU; one
     ``env_step`` and one ``observe`` under
     ``torch.cuda.set_sync_debug_mode("error")``; ``ppo_train_device`` for
     3 updates of 512 episodes, saved and reloaded (``artifacts/chip_smoke/``),
     one ``update`` and one ``make_train_step`` step timed; and
     ``rollout_multi`` over 8 stacked graphs, its anchors against each
     graph's own search; a ``torch.profiler`` trace of one B = 512 rollout
     (``traces/agent_1m/``: kernel time, launches, busy share);
 11. question answering: the XL dev world (``samples/synth_v4_sharedxl_*``,
     1,835 titled paragraphs as named entities under topic summaries of 64 and
     communities of 8: 1,868 nodes) built and indexed by the port on the card,
     saved and loaded onto the CPU; its first 96 dev questions (of 150) through
     ``RetrievalService.answer`` on the card and on the CPU (answer, rationale,
     citations, retrieved nodes, evidence ids and context text equal; a
     difference passes only as a counted near tie of two scores within 1e-5),
     with per-answer latency on both, searches per answer, gold containment
     and token F1, and the card's busy share over 16 warm answers (kernel
     time in a ``torch.profiler`` trace, ``traces/answer_xl/``, over the wall
     of the same 16 answers untraced just before); then 32 shared-KB
     questions over phase 8's graph, card against CPU, with at least one
     ``dense_binmax`` launch per answer. Session files go to temporary
     working directories, removed afterwards;
 12. build, answer and score: ``run_pipeline`` over the XL dev world on the
     card and on the CPU (stage seconds; the 9 artifact files,
     ``structure.json`` and ``meta.json`` byte for byte equal, the index's
     ids, IDF and associations equal, its embeddings and LSA basis within
     1e-5; n_pad 6,144, so every one-query search goes through
     ``dense_binmax``); ``run_benchmark(system="both")`` over the first 96 dev
     questions (of 150), over the card's graph on the card and the CPU's on the CPU
     (rows and retrieved nodes equal, near ties counted; aggregate F1, EM and
     recall@10; per-question ms; at least one ``dense_binmax`` launch per
     ah_rag question); ``run_benchmark(system="ah_rag")`` over the first 32
     ``synth_v4_dev`` items (a graph per question) card against CPU, with
     ``eval_gate``'s verdict at ``make gate-v4``'s bars (printed only);
     ``build_question_fleet`` over 16 of them and one scripted
     ``rollout_multi`` over each stack, card against CPU; and
     ``spherical_kmeans`` over the 1M rung's entity rows (k 724; init and 25
     EM steps timed apart) and over the 131k rung's on the card and the CPU
     (k 256; assignments equal but counted near ties);
 13. the host training path over phase 12's XL graphs (kept alive, in the
     same scratch directory): ``AHRAGGymEnv`` under a scripted action cycle
     over 64 dev questions, card against CPU (observations within 1e-5,
     rewards, dones, masks and selections equal, near ties counted; at least
     one ``dense_binmax`` launch per reset; ms per step); the gym against
     ``vec_env.env_reset``/``env_step`` on the card (``TestVecEnvParity``'s
     sequences and the end action over 32 questions); ``collect_trajectories``,
     ``train_rl`` and ``eval_rl_policy --policy`` card against CPU and
     ``train_bc`` on the card; ``run_pipeline`` over the XL train world and
     ``ppo_train`` over its 150 questions (4 gyms, 32 batches, early stop
     allowed: episodes/s, step and update ms, batch rewards, launches), and a
     2-batch run resumed to 4 that restores the saved state bit for bit; that
     policy through ``eval_rl_policy`` (64 dev questions) and ``rl_transfer
     --strip-context`` (32); ``train_knob_policy`` (400 steps) and
     ``evaluate_policy`` on the v6 matrices, then ``run_benchmark`` steered by
     that policy over 32 dev questions, card against CPU; and
     ``cluster_eval.run`` at 10,000 entities, 48 topics, 8 super-topics, card
     against CPU, beside the JAX report's L1 quality;
 14. the learned models, each step on the card and on the CPU (the CPU side in
     two processes of their own, spawned with the card hidden, alongside):
     the sample corpus through ``ContrastiveEncoder`` and as a learned-encoder
     graph (D 768, n_pad 5,120, float32); the two shipped readers' logits on
     64 featurized v5 TEST reads; the reader ensemble alone over the 120 v5
     TEST items (answers equal, F1/EM beside the JAX package's); the same
     items through ``run_benchmark`` with the ensemble as the answer stage
     (reports equal); the learned graph behind the single-stage
     ``RetrievalService`` at buckets 1/4/64/128/256 (``dense_binmax`` and
     ``dense_binmax2`` at D 768; ids equal, near ties counted) and under 1 and
     32 callers; ``tools/encoder_recall_eval.py``'s learned cells over 32 v6
     dev items (rows equal); MiniLM from a seeded init over the 4,050 lines;
     the reader's and the contrastive encoder's trainers at full width from
     the same initial weights and draws (losses within 1e-4 relatively); and
     both bin-max kernels at the learned graph's shape with their bounds and
     library calls;

and prints the corpus bytes each redesigned kernel requests by its design
(a count, not a DRAM reading), the kernels' JSON line (times at the
main-path shapes, bounds, launch counts, errors, achieved TFLOP/s, share of
the bound, ``binmax_eps`` per type; the float32 shapes of ``binmax2`` and
``tile_topk`` under ``"float32"``, ``binmax``'s 1M bf16 B = 64 and 131k f32
B = 64 shapes under ``"bfloat16 B=64"`` and ``"float32 B=64"``), the card's
name and power limit, and last the
contract line ``{"ok": true, "device": {...}}``. Any failed check raises and
the script exits non-zero. Without a CUDA device it exits non-zero at once.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import math
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 on the tensor cores, float32
# outside them, HBM3 bandwidth. The bin-max kernels' products are bf16 for bf16
# storage and IEEE float32 for float32 storage.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
TOL = {"bfloat16": 2e-6, "float32": 1e-5}   # bf16 products are exact: only summation order differs
# The tile top-k's values against its plain version over the phase-2 grid,
# whatever the storage type: bf16 products are exact, but the kernel and the
# float32 matmul still sum them in different orders, and at B = 128,
# k = tile_n (every score of the tile compared) sound runs read above 2e-6
# in bf16 as in float32. A kernel that rounds its scores to bf16 reads far
# above this limit; phase 2 measures both and checks that the limit parts them.
TOPK_TOL = 1e-5
# dense_binmax's batches in phase 2: every query chunk (8 to 128 in bf16, 8 to
# 64 in float32), a partial last chunk and several chunks
BINMAX_BATCHES = (1, 4, 5, 16, 20, 64, 100, 128, 200)
SAMPLES = Path(__file__).resolve().parent / "samples"

_T0 = time.perf_counter()


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - _T0:7.1f}s] {msg}", flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call over ``reps`` calls, by CUDA events, after
    one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(flops: float, nbytes: float, dtype: str) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")


def kernel_report(info: dict) -> dict:
    """ptxas's registers and spills per kernel from the build log, and each
    kernel's count of HGMMA (wgmma) and FFMA instructions from ``cuobjdump
    -sass`` of the built library, by names that ``cu++filt`` (both beside
    ``nvcc``) demangles. Fails unless every bf16 instantiation of
    ``ahrag_binmax2``, ``ahrag_binmax`` and ``ahrag_tile_topk``
    (``binmax2_bf16_kernel<...>``, ``binmax_qmajor_kernel<__nv_bfloat16, ...>`` and
    ``tile_topk_kernel<__nv_bfloat16, ...>``, one per query chunk and, for
    binmax2, per mask kind: 4 + 5 + 2) runs HGMMA."""
    import os
    import re
    from ahrag_tpu_torch.ops import _build
    tools = os.path.dirname(_build.find_nvcc())
    sass = subprocess.run([os.path.join(tools, "cuobjdump"), "-sass", info["path"]],
                          capture_output=True, text=True, check=True).stdout
    blocks = {b.split("\n", 1)[0].strip(): b for b in re.split(r"\n\s*Function : ", sass)[1:]}
    mangled = sorted(set(blocks) | set(re.findall(r"Compiling entry function '(\w+)'", info["log"])))
    demangled = subprocess.run([os.path.join(tools, "cu++filt")], input="\n".join(mangled),
                               capture_output=True, text=True, check=True).stdout.splitlines()
    # "void (anonymous namespace)::name<args>(params)" -> "name<args>"
    short = {m: d.split("::", 1)[-1].split(">(")[0] + ">" if ">(" in d
             else d.split("::", 1)[-1].split("(")[0] for m, d in zip(mangled, demangled)}
    report, cur = {}, None
    for ln in info["log"].splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            cur = short[m.group(1)]
            report[cur] = {}
        elif cur and "registers" in ln:
            report[cur]["registers"] = int(re.search(r"Used (\d+) registers", ln).group(1))
        elif cur and "spill" in ln:
            report[cur]["spill_bytes"] = sum(int(x) for x in re.findall(r"(\d+) bytes spill", ln))
    for name, block in blocks.items():
        report.setdefault(short[name], {}).update(
            hgmma=len(re.findall(r"\bHGMMA\b", block)), ffma=len(re.findall(r"\bFFMA\b", block)),
            lds=len(re.findall(r"\bLDS\b", block)),
            ld_generic=len(re.findall(r"\bLD\.", block)) + len(re.findall(r"\bLD\s", block)))
    bf16 = {k: v for k, v in report.items()
            if k.startswith(("binmax2_bf16_kernel<", "binmax_qmajor_kernel<__nv_bfloat16",
                             "tile_topk_kernel<__nv_bfloat16"))}
    check(len(bf16) == 11, f"eleven bf16 instantiations of binmax2, binmax and tile_topk: "
          f"{sorted(bf16)}")
    for name, r in bf16.items():
        check(r.get("hgmma", 0) > 0, f"{name} runs no HGMMA: {r}")
    return report


def reset_counts() -> None:
    from ahrag_tpu_torch.ops.binmax import dense_binmax, dense_binmax2
    from ahrag_tpu_torch.ops.tile_topk import tile_topk
    dense_binmax2.launches = 0
    dense_binmax.launches = 0
    tile_topk.launches = 0


def read_counts() -> dict:
    from ahrag_tpu_torch.ops.binmax import dense_binmax, dense_binmax2
    from ahrag_tpu_torch.ops.tile_topk import tile_topk
    return {"binmax2_cuda": dense_binmax2.launches, "binmax_cuda": dense_binmax.launches,
            "tile_topk_cuda": tile_topk.launches}


def compare_topk(what: str, q, emb, vals, ids, ref_vals, ref_ids, tol: float,
                 exact: bool = False) -> tuple[float, int]:
    """A kernel's top-k (vals, ids) against its plain version's, slot by slot,
    on any matching shapes [..., B, k] with global row ids. Values agree
    within ``tol`` (``exact``: equal). Ids are equal, with every ``NEG_INF``
    slot's id included; on float inputs two rows whose scores lie within
    ``tol`` of each other may trade places (the kernel and the float32 matmul
    sum in different orders), and such a swap counts only when the kernel's
    row truly scores within ``tol`` of the slot's plain value. ``exact``
    inputs are sums that float32 holds exactly, so there no swap is allowed.
    Returns (max |vals - ref_vals|, number of swaps)."""
    import torch
    err = (vals - ref_vals).abs().max().item() if vals.numel() else 0.0
    check(err <= (0.0 if exact else tol), f"{what}: values differ by {err}")
    live = ref_vals > -1e29
    check(bool((live == (vals > -1e29)).all()), f"{what}: NEG_INF slots differ")
    differ = ids.long() != ref_ids.long()
    check(not bool((differ & ~live).any()), f"{what}: a NEG_INF slot's id differs")
    swaps = int(differ.sum())
    if swaps:
        check(not exact, f"{what}: {swaps} ids differ on exact inputs")
        b = torch.arange(q.shape[0], device=q.device).view(-1, 1)
        b = b.expand(ids.shape[-2], ids.shape[-1]).expand_as(ids)
        true = (emb[ids.long()[differ]].double() * q[b[differ]].double()).sum(-1)
        gap = (true - ref_vals[differ].double()).abs().max().item()
        check(gap <= tol, f"{what}: {swaps} ids differ, not within a near tie ({gap})")
        srt = torch.where(live, ids.long(), -1 - torch.arange(ids.shape[-1],
                          device=ids.device)).sort(dim=-1).values
        check(not bool((srt[..., 1:] == srt[..., :-1]).any()), f"{what}: a row twice")
    return err, swaps


def phase_kernels_vs_plain(dev) -> dict:
    """Both bin-max kernels against their plain versions on small real-width
    inputs: D = 384, 6 tiles (fewer work items than SMs), n_valid short of N,
    a random mask with tile 1 fully masked, masked and trivial. ``dense_binmax2``
    at B 128, 256 (the service's bucket) and 512 on exact inputs (halves in
    [-1, 1]: every score is a float32-exact sum in any order, so bins and
    supermax must be equal) and on unit vectors (within ``TOL``), with a
    control (the plain bins rounded to bf16, as a kernel that kept bf16 scores
    would give) that must read above ``TOL``; ``dense_binmax`` at B 1, 4, 5,
    16, 20, 64, 100, 128 and 200 on unit vectors, with its own control. Then
    ``dense_binmax2`` on exact inputs at D = 200 (the last 64-element box
    partly past D, zero-filled) and D = 768 (32-query chunks in bf16), both
    types, masked and trivial."""
    import torch
    from ahrag_tpu_torch.ops.binmax import (dense_binmax, dense_binmax2,
                                            dense_binmax2_ref, dense_binmax_ref)
    gen = torch.Generator().manual_seed(0)
    n, d, tile_n = 6 * 1024, 384, 1024
    err = {"binmax2_cuda": 0.0, "binmax_cuda": 0.0}
    control = 0.0
    control1 = 0.0          # dense_binmax's

    def draw(rows, family, dim=d):
        if family == "exact":
            return torch.randint(-2, 3, (rows, dim), generator=gen) / 2.0
        x = torch.randn((rows, dim), generator=gen)
        return x / x.norm(dim=1, keepdim=True)

    for dtype, family in itertools.product((torch.bfloat16, torch.float32), ("exact", "unit")):
        tol = 0.0 if family == "exact" else TOL[str(dtype).split(".")[1]]
        emb = draw(n, family).to(dev, dtype)
        mask = torch.rand(n, generator=gen) > 0.2
        mask[tile_n:2 * tile_n] = False
        mask = mask.to(dev)
        n_valid = n - 300
        for b in (128, 256, 512):
            q = draw(b, family).to(dev, dtype)
            for trivial in (False, True):
                bins, smax = dense_binmax2(q, emb, n_valid, mask, tile_n, trivial)
                rb, rs = dense_binmax2_ref(q, emb, n_valid, mask, tile_n, trivial)
                e = max((bins - rb).abs().max().item(), (smax - rs).abs().max().item())
                what = f"binmax2 {dtype} {family} B={b} trivial={trivial}"
                log(f"  {what}: max|kernel-plain| {e:.3e}")
                check(e <= tol, f"{what} err {e} > {tol}")
                if not trivial:
                    check(bool((bins[1] == -1e30).all() and (smax[:, 1] == -1e30).all()),
                          f"{what}: the fully masked tile")
                if family == "unit":
                    err["binmax2_cuda"] = max(err["binmax2_cuda"], e)
                    live = rb > -1e29
                    control = max(control, (rb.to(torch.bfloat16).float() - rb)[live]
                                  .abs().max().item())
        if family == "unit":
            for b in BINMAX_BATCHES:
                q = draw(b, family).to(dev, dtype)
                out = dense_binmax(q, emb, n_valid, mask, tile_n)
                ref = dense_binmax_ref(q, emb, n_valid, mask, tile_n)
                e = (out - ref).abs().max().item()
                log(f"  binmax {dtype} B={b}: max|kernel-plain| {e:.3e}")
                check(e <= tol, f"binmax {dtype} B={b} err {e} > {tol}")
                err["binmax_cuda"] = max(err["binmax_cuda"], e)
                live = ref > -1e29
                control1 = max(control1, (ref.to(torch.bfloat16).float() - ref)[live]
                               .abs().max().item())
    for dtype, dim in itertools.product((torch.bfloat16, torch.float32), (200, 768)):
        emb = draw(n, "exact", dim).to(dev, dtype)
        mask = torch.rand(n, generator=gen) > 0.2
        mask[tile_n:2 * tile_n] = False
        mask = mask.to(dev)
        q = draw(128, "exact", dim).to(dev, dtype)
        for trivial in (False, True):
            bins, smax = dense_binmax2(q, emb, n - 300, mask, tile_n, trivial)
            rb, rs = dense_binmax2_ref(q, emb, n - 300, mask, tile_n, trivial)
            e = max((bins - rb).abs().max().item(), (smax - rs).abs().max().item())
            what = f"binmax2 {dtype} exact D={dim} trivial={trivial}"
            log(f"  {what}: max|kernel-plain| {e:.3e}")
            check(e == 0.0, f"{what} err {e} > 0")
    torch.cuda.synchronize()
    log(f"  binmax2: exact inputs equal; unit vectors {err['binmax2_cuda']:.3e} against "
        f"{json.dumps(TOL)}; control (plain bins rounded to bf16) {control:.3e}")
    check(control > max(TOL.values()), f"the bf16-rounding control ({control}) passes the "
          f"limits {TOL}")
    log(f"  binmax: unit vectors {err['binmax_cuda']:.3e} against {json.dumps(TOL)}; control "
        f"(plain bins rounded to bf16) {control1:.3e}")
    check(control1 > max(TOL.values()), f"binmax's bf16-rounding control ({control1}) passes "
          f"the limits {TOL}")
    return err


def phase_binmax_exact(dev) -> None:
    """``dense_binmax`` against its plain version on exact inputs (halves in
    [-1, 1]: every score is a float32-exact sum in any order, so the bins must
    be equal) over both types, B 1/4/5/16/20/64/100/128/200 (every query chunk,
    a partial last chunk, two chunks of 128 in bf16 and up to four of 64 in
    float32), tile_n 1024 and 4096, and D = 200 (a partial box), 384 and 768
    (64-query chunks in bf16 above B = 64): 12,288 rows, n_valid short of N,
    a random mask with tile 1 fully masked."""
    import torch
    from ahrag_tpu_torch.ops.binmax import binmax_chunk, dense_binmax, dense_binmax_ref
    gen = torch.Generator().manual_seed(2)
    n, cases, chunks = 12288, 0, set()
    for dtype, dim in itertools.product((torch.bfloat16, torch.float32), (200, 384, 768)):
        emb = (torch.randint(-2, 3, (n, dim), generator=gen) / 2.0).to(dev, dtype)
        for tile_n in (1024, 4096):
            mask = torch.rand(n, generator=gen) > 0.2
            mask[tile_n:2 * tile_n] = False
            mask = mask.to(dev)
            for b in BINMAX_BATCHES:
                q = (torch.randint(-2, 3, (b, dim), generator=gen) / 2.0).to(dev, dtype)
                out = dense_binmax(q, emb, n - 300, mask, tile_n)
                ref = dense_binmax_ref(q, emb, n - 300, mask, tile_n)
                what = f"binmax {dtype} exact D={dim} tile_n={tile_n} B={b}"
                e = (out - ref).abs().max().item()
                check(out.shape == ref.shape and e == 0.0, f"{what}: err {e}")
                check(bool((out[:, 128:256] == -1e30).all()), f"{what}: the fully masked tile")
                chunks.add((str(dtype).split(".")[1],
                            binmax_chunk(b, dim, dtype == torch.bfloat16)))
                cases += 1
    torch.cuda.synchronize()
    log(f"  binmax: exact inputs equal in {cases} cases, query chunks {sorted(chunks)}")


def phase_tile_topk_vs_plain(dev) -> dict:
    """The tile top-k kernel against its plain version over the grid: both
    types, tile_n 256/512/1024, B 1/5/128, k 1/5/10 (and k = tile_n at B 5 and
    128), n_valid short of N, a random mask with tile 1 fully masked. Exact
    inputs (halves in [-1, 1]: every score is a float32-exact sum) must give
    equal ids and values; unit vectors values within ``TOPK_TOL``. A control
    (the plain values rounded to bf16, as a kernel that kept bf16 scores
    would give) must read above ``TOPK_TOL``. Then the tie case: all rows
    identical; and exact inputs off the main shape: D = 200 (a partial
    64-element box in bf16, a partial 32-element stage in float32), D = 768
    in bf16 and tile_n = 2048 in both types (16-query chunks), B 5 and 128, k
    5 and tile_n."""
    import torch
    from ahrag_tpu_torch.ops.tile_topk import (dense_topk_fused, dense_topk_fused_ref,
                                               tile_topk)
    gen = torch.Generator().manual_seed(1)
    n, d = 6144, 384
    err, swaps, cases = 0.0, 0, 0
    sound = {}     # (dtype, tile_n) -> largest unit-vector error at B = 128, k = tile_n
    control = 0.0

    def draw(rows, family, dim=d):
        if family == "exact":
            return torch.randint(-2, 3, (rows, dim), generator=gen) / 2.0
        x = torch.randn((rows, dim), generator=gen)
        return x / x.norm(dim=1, keepdim=True)

    for dtype, tile_n, family in itertools.product(
            (torch.bfloat16, torch.float32), (256, 512, 1024), ("exact", "unit")):
        emb = draw(n, family).to(dev, dtype)
        mask = torch.rand(n, generator=gen) > 0.2
        mask[tile_n:2 * tile_n] = False
        mask = mask.to(dev)
        n_valid = n - 300
        for b, k in [(b, k) for b in (1, 5, 128) for k in (1, 5, 10, tile_n)
                     if k != tile_n or b > 1]:
            q = draw(b, family).to(dev, dtype)
            vals, ids = tile_topk(q, emb, n_valid, k, tile_n, mask)
            rv, ri = dense_topk_fused_ref(q, emb, n_valid, k, tile_n, mask)
            what = f"tile_topk {dtype} tile_n={tile_n} {family} B={b} k={k}"
            e, sw = compare_topk(what, q, emb, vals, ids, rv, ri, TOPK_TOL,
                                 exact=family == "exact")
            check(bool((ids[1] == tile_n).all()), f"{what}: the masked tile's ids")
            if family == "unit" and (b, k) == (128, tile_n):
                sound[f"{dtype} tile_n={tile_n}"] = e
                live = rv > -1e29
                control = max(control, (rv.to(torch.bfloat16).float() - rv)[live]
                              .abs().max().item())
            if sw or k == tile_n:
                log(f"  {what}: max|kernel-plain| {e:.3e}, {sw} near-tie swaps")
            err, swaps, cases = max(err, e), swaps + sw, cases + 1
    for dtype in (torch.bfloat16, torch.float32):
        emb = torch.zeros((1024, d), device=dev, dtype=dtype)
        emb[:, 0] = 1.0
        q = emb[:1].contiguous()
        _, ids = tile_topk(q, emb, 1024, 5, 256)
        check(ids[:, 0].tolist() == [[t * 256 + j for j in range(5)] for t in range(4)],
              f"tie case per tile {dtype}: {ids[:, 0].tolist()}")
        _, ids = dense_topk_fused(q, emb, 1024, 5, tile_n=256)
        check(ids.tolist() == [[0, 1, 2, 3, 4]], f"tie case merged {dtype}: {ids.tolist()}")
        cases += 1
    off_shape = []
    for dtype, dim, tile_n in ((torch.bfloat16, 200, 1024), (torch.float32, 200, 1024),
                               (torch.bfloat16, 768, 1024), (torch.bfloat16, 384, 2048),
                               (torch.float32, 384, 2048)):
        emb = draw(3 * tile_n, "exact", dim).to(dev, dtype)
        mask = torch.rand(3 * tile_n, generator=gen) > 0.2
        mask[tile_n:2 * tile_n] = False
        mask = mask.to(dev)
        for b, k in itertools.product((5, 128), (5, tile_n)):
            q = draw(b, "exact", dim).to(dev, dtype)
            vals, ids = tile_topk(q, emb, 3 * tile_n - 300, k, tile_n, mask)
            rv, ri = dense_topk_fused_ref(q, emb, 3 * tile_n - 300, k, tile_n, mask)
            what = f"tile_topk {dtype} exact D={dim} tile_n={tile_n} B={b} k={k}"
            compare_topk(what, q, emb, vals, ids, rv, ri, TOPK_TOL, exact=True)
            check(bool((ids[1] == tile_n).all()), f"{what}: the masked tile's ids")
            cases += 1
        off_shape.append(f"{dtype} D={dim} tile_n={tile_n}")
    log(f"  tile_topk exact inputs equal off the main shape: {off_shape}")
    torch.cuda.synchronize()
    log(f"  tile_topk: {cases} cases, max|kernel-plain| {err:.3e}, near-tie swaps "
        f"{swaps} (unit vectors only); limit {TOPK_TOL:.1e}; at B=128, k=tile_n on unit "
        f"vectors {json.dumps(sound)}; control (plain values rounded to bf16) "
        f"{control:.3e}")
    check(control > TOPK_TOL, f"the bf16-rounding control ({control}) passes the "
          f"limit {TOPK_TOL}")
    return {"tile_topk_cuda": err}


def kernel_row(name, kernel, plain, library, flops, nbytes, dtype, reps,
               compare=None, plain_reps=None) -> dict:
    """Times and error of one kernel at one shape (launches filled in later),
    with its achieved TFLOP/s and its share of the bound. ``compare(out,
    ref)`` checks the outputs and returns the error; by default the largest
    absolute difference within the type's tolerance."""
    import torch
    out, ref = kernel(), plain()
    outs = out if isinstance(out, tuple) else (out,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    if compare is None:
        e = max((a - b).abs().max().item() for a, b in zip(outs, refs))
        check(e <= TOL[dtype], f"{name} at the main-path shape: err {e} > {TOL[dtype]}")
    else:
        e = compare(out, ref)
    del out, ref, outs, refs
    torch.cuda.synchronize()
    ms = cuda_ms(kernel, reps)
    plain_ms = cuda_ms(plain, plain_reps or max(2, reps // 4))
    library_ms = cuda_ms(library, reps)
    b_ms, b_by = bound(flops, nbytes, dtype)
    return {"max_abs_err": e, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": library_ms, "tflops": flops / ms / 1e9,
            "bound_share": b_ms / ms}


def run_rung(dev, n_entities: int, n_queries: int, emb_dtype: str) -> dict:
    """Build one bench rung on the card and drive hybrid search through it."""
    import numpy as np
    import torch
    from ahrag_tpu_torch.bench_data import (bench_queries, bench_tensors,
                                            build_bench_arrays, certificate_audit,
                                            cpu_reference_search, round_bf16)
    from ahrag_tpu_torch.graph.search import (SEM_FLUSH_EPS, SearchWeights,
                                              hybrid_search_batch)
    from ahrag_tpu_torch.ops.topk import refined_masked_topk_cert

    t0 = time.perf_counter()
    arrs = build_bench_arrays(n_entities, max(8, n_entities // 64))
    if emb_dtype == "bfloat16":
        # the oracle scores the same bf16-rounded values the device stores
        arrs.emb = round_bf16(arrs.emb)
    q_mat = bench_queries(arrs, n_queries)
    if emb_dtype == "bfloat16":
        q_mat = round_bf16(q_mat)
    log(f"  host arrays: {arrs.n} nodes, {time.perf_counter() - t0:.1f}s")

    reset_counts()   # the main path: index build (eps calibration) + search
    t0 = time.perf_counter()
    gt = bench_tensors(arrs, emb_dtype, device=dev)
    w = SearchWeights.create(device=dev)
    q_dev = torch.from_numpy(q_mat).to(dev)
    res = hybrid_search_batch(gt, q_dev, w, top_k=5, member_top_m=5)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    variants = [q_dev] + [torch.roll(q_dev, 1 + 7 * v, dims=0) for v in range(3)]
    reps = 12
    batches = itertools.cycle(variants)
    batch_ms = cuda_ms(lambda: hybrid_search_batch(
        gt, next(batches), w, top_k=5, member_top_m=5), reps)
    counts = read_counts()
    log(f"  n_pad {gt.n_pad}, build+first batch {first_s:.1f}s, batch_ms "
        f"{batch_ms:.3f}, launches {counts}")

    dev_ids = [[int(i) for i, ok in zip(res.reranked_idx[b].tolist(),
                                        res.reranked_valid[b].tolist()) if ok]
               for b in range(8)]
    mism = sum([i for i, _ in cpu_reference_search(arrs, q_mat[b])] != dev_ids[b]
               for b in range(8))
    audit = certificate_audit(gt, q_dev, res)
    _, _, cert = refined_masked_topk_cert(
        q_dev, gt.emb, gt.indexed & gt.valid, 5, margin=12,
        flush_eps=SEM_FLUSH_EPS, mask_trivial=gt.mask_trivial,
        emb_binpack=gt.emb_binpack)
    out = {"n_nodes": arrs.n, "n_pad": gt.n_pad, "emb_dtype": emb_dtype,
           "n_queries": n_queries, "parity_mismatches_of_8": int(mism),
           "cert_audit": audit, "certified_share": float(cert.float().mean()),
           "batch_ms": batch_ms, "qps": n_queries / batch_ms * 1e3,
           "batches_timed": reps, "launches": counts}
    log(f"  {json.dumps(out)}")
    check(mism == 0, f"rank parity {mism}/8 at {arrs.n} nodes")
    check(audit["audit_mismatches"] == 0, f"certificate audit {audit}")
    check(out["certified_share"] == 1.0, f"certified share {out['certified_share']}")
    check(np.isfinite(res.reranked_score.cpu().numpy()).all(), "finite scores")
    check(counts["binmax2_cuda"] > 0, "binmax2 kernel launched on the path")
    check(counts["binmax_cuda"] > 0, "binmax kernel launched on the path (calibration)")
    return {"gt": gt, "arrs": arrs, "q_dev": q_dev, "w": w, "rung": out}


def run_flat(dev, emb, n_valid: int, q, dtype: str, label: str) -> dict:
    """Flat exact top-k (k = 5) through ``dense_topk`` over a rung's corpus:
    ids and values against ``dense_topk_ref`` on the card, batch time and qps
    over 12 varied batches, and the kernel's row (its time, the plain
    version's, the library's and the bound)."""
    import torch
    from ahrag_tpu_torch.ops import dense_topk, dense_topk_ref
    from ahrag_tpu_torch.ops.tile_topk import dense_topk_fused_ref, tile_topk
    k, (B, D), N = 5, q.shape, emb.shape[0]
    reset_counts()   # the main path: dense_topk over the whole corpus
    t0 = time.perf_counter()
    vals, ids = dense_topk(q, emb, n_valid, k)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    batches = itertools.cycle([q] + [torch.roll(q, 1 + 7 * v, dims=0) for v in range(3)])
    reps = 12
    batch_ms = cuda_ms(lambda: dense_topk(emb=emb, q=next(batches), n_valid=n_valid,
                                          k=k), reps)
    counts = read_counts()
    rv, ri = dense_topk_ref(q, emb, n_valid, k)
    tol = TOPK_TOL
    err, swaps = compare_topk(f"dense_topk {label}", q, emb, vals, ids, rv, ri, tol)
    check(tuple(ids.shape) == (B, k) and bool(torch.isfinite(vals).all()),
          f"dense_topk {label}: shape or values")
    check(counts["tile_topk_cuda"] > 0, f"tile top-k kernel launched on the {label} path")
    del rv, ri
    T = N // 1024
    esize = emb.element_size()
    row = kernel_row(
        "tile_topk_cuda",
        lambda: tile_topk(q, emb, n_valid, k),
        lambda: dense_topk_fused_ref(q, emb, n_valid, k),
        lambda: torch.topk(torch.matmul(q, emb.T), k),
        2.0 * B * N * D, N * D * esize + B * D * esize + T * B * k * 8, dtype, reps=10,
        compare=lambda out, ref: compare_topk(f"tile_topk {label}", q, emb, *out, *ref,
                                              tol)[0],
        plain_reps=1)
    # the same kernel with one selection pass (k = 1): the rest of k = 5's
    # time is the four further passes over the score tile
    row["ms_k1"] = cuda_ms(lambda: tile_topk(q, emb, n_valid, 1), 10)
    out = {"shape": label, "n_valid": n_valid, "B": B, "k": k, "batch_ms": batch_ms,
           "qps": B / batch_ms * 1e3, "first_call_s": first_s, "batches_timed": reps,
           "launches": counts, "max_abs_err_vs_ref": err, "near_tie_swaps": swaps,
           "kernel": row}
    log(f"  {json.dumps(out)}")
    return out


def sample_questions(n: int) -> list:
    """The first ``n`` questions of the shared-KB samples, train, dev, test."""
    qs = []
    for split in ("train", "dev", "test"):
        path = SAMPLES / f"synth_v4_shared_{split}.jsonl"
        qs += [json.loads(ln)["question"] for ln in path.read_text().splitlines() if ln.strip()]
    return qs[:n]


def corpus_lines() -> list:
    """The 4,050 non-empty lines of the sample corpus, train, dev, test."""
    lines = []
    for split in ("train", "dev", "test"):
        text = (SAMPLES / f"synth_v4_shared_corpus_{split}.txt").read_text()
        lines += [ln for ln in text.splitlines() if ln.strip()]
    return lines


def host_ms(fn, reps: int) -> tuple[float, object]:
    """Median host milliseconds of ``fn`` over ``reps`` calls, and its last result."""
    times, out = [], None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2], out


def phase_serve_buckets(dev, enc, idf, r1, gt_cpu) -> dict:
    """The first 256 sample questions at buckets 4, 16, 64 and 256: native
    featurize + pack against the Python featurizer (bit for bit, both timed),
    then the 64 bucket through ``encode_and_search`` on the card and the CPU."""
    import numpy as np
    import torch
    from ahrag_tpu_torch.graph.search import SearchWeights
    from ahrag_tpu_torch.models.encoder.hashed import _project_normalize_sparse
    from ahrag_tpu_torch.serve import batch_bucket, encode_and_search, pack_coo, pack_queries
    questions = sample_questions(256)
    check(len(questions) == 256, "256 sample questions")

    def python_pack(qs):
        padded = qs + [""] * (batch_bucket(len(qs)) - len(qs))
        counts = enc._count_matrix(padded)
        rows, cols = np.nonzero(counts)
        return pack_coo(rows, cols, counts[rows, cols], len(padded), enc.buckets)

    featurize = {}
    for n in (4, 16, 64, 256):
        qs = questions[:n]
        native_ms, (_, n_rows, packed) = host_ms(lambda: pack_queries(qs, enc), 5)
        python_ms, py_packed = host_ms(lambda: python_pack(qs), 3 if n < 256 else 1)
        check(n_rows == n and packed.shape == py_packed.shape
              and np.array_equal(packed, py_packed),
              f"bucket {n}: native packed array differs from the Python one")
        featurize[n] = {"native_ms": native_ms, "python_ms": python_ms,
                        "packed": list(packed.shape)}
        log(f"  bucket {n}: packed {packed.shape} bit-identical; featurize+pack native "
            f"{native_ms:.3f} ms, Python {python_ms:.3f} ms")
    _, n_rows, packed = pack_queries(questions[:64], enc)
    reset_counts()
    t0 = time.perf_counter()
    out_gpu = encode_and_search(packed, enc._proj, idf.to(dev), r1["gt"], r1["w"],
                                n_rows=n_rows, top_k=5, member_top_m=5).cpu()
    serve_ms = (time.perf_counter() - t0) * 1e3
    counts = read_counts()
    out_cpu = encode_and_search(packed, enc._proj.cpu(), idf, gt_cpu,
                                SearchWeights.create(device="cpu"),
                                n_rows=n_rows, top_k=5, member_top_m=5)
    score_err = (out_gpu - out_cpu).abs().max().item()
    # the bf16 graph scores q rounded to bf16: where the float32 encodes on the
    # card and the CPU differ in a last bit across a rounding midpoint, a
    # component of q moves by one bf16 step. The semantic score, and the
    # rerank score (alpha < 1 times it plus terms that do not depend on q),
    # then move by at most sum_d |dq_d| * max_r |emb[r, d]| over the flipped
    # components d of that query; the limit is that plus the 1e-5 of an
    # unflipped run
    key = torch.from_numpy(packed[:, 0]).long()
    rows, cols = key // enc.buckets, key % enc.buckets
    vals = torch.from_numpy(packed[:, 1])
    q_card = _project_normalize_sparse(rows.to(dev), cols.to(dev), vals.to(dev),
                                       enc._proj, idf.to(dev), n_rows).cpu()
    q_cpu = _project_normalize_sparse(rows, cols, vals, enc._proj.cpu(), idf, n_rows)
    q_err = (q_card - q_cpu).abs().max().item()
    dq = (q_card.to(torch.bfloat16).float() - q_cpu.to(torch.bfloat16).float()).abs()
    flips = int((dq > 0).sum())
    emb_absmax = r1["gt"].emb.float().abs().amax(dim=0).cpu()
    score_tol = 1e-5 + (dq * emb_absmax).sum(dim=1).max().item()
    log(f"  bucket 64 through encode_and_search: {serve_ms:.1f} ms, launches {counts}, "
        f"max|cuda-cpu| {score_err:.3e}; encoded q max|cuda-cpu| {q_err:.3e}, "
        f"{flips} of {q_card.numel()} components round to another bf16 value, "
        f"score limit {score_tol:.3e}")
    check(out_gpu[..., 0].long().tolist() == out_cpu[..., 0].long().tolist(),
          "bucket 64: serve ids on the card differ from the CPU's")
    check(bool((out_gpu[..., 3] == out_cpu[..., 3]).all()), "bucket 64: valid flags")
    check(q_err <= 1e-5, f"bucket 64: encoded queries differ by {q_err}")
    check(score_err <= score_tol, f"bucket 64: serve scores differ by {score_err} "
          f"(tolerance {score_tol}, {flips} bf16 flips)")
    return {"featurize": featurize, "bucket64_ms": serve_ms, "bucket64_launches": counts}


def phase_encode(dev, d: int) -> dict:
    """``encode_device`` over every non-empty line of the sample corpus, with an
    IDF from ``document_frequencies``, on the card and on the CPU."""
    import numpy as np
    import torch
    from ahrag_tpu_torch.models.encoder.hashed import HashedNGramEncoder
    lines = corpus_lines()
    enc = HashedNGramEncoder(dim=d, device=dev)
    enc_cpu = HashedNGramEncoder(dim=d, device="cpu")
    enc_cpu._proj = enc._proj.cpu()
    df_ms, df = host_ms(lambda: enc.document_frequencies(lines), 1)
    idf = (np.log((1.0 + len(lines)) / (1.0 + df)) + 1.0).astype(np.float32)
    enc.encode_device(lines[:16], idf=idf)
    torch.cuda.synchronize()

    def on_card():
        out = enc.encode_device(lines, idf=idf)
        torch.cuda.synchronize()
        return out
    card_ms, emb = host_ms(on_card, 3)
    cpu_ms, emb_cpu = host_ms(lambda: enc_cpu.encode_device(lines, idf=idf), 1)
    err = (emb.cpu() - emb_cpu).abs().max().item()
    out = {"lines": len(lines), "document_frequencies_ms": df_ms, "card_ms": card_ms,
           "cpu_ms": cpu_ms, "max_abs_err": err}
    log(f"  {json.dumps(out)}")
    check(tuple(emb.shape) == (len(lines), d) and bool(torch.isfinite(emb).all()),
          "encode_device shape and values")
    check(err <= 1e-5, f"encode_device card vs CPU differ by {err}")
    return out


def corpus_graph(hg):
    """The sample corpus as a graph: each of its 4,050 lines an entity's
    description, under topic summaries of 64 members and communities of 8
    topics (4,122 nodes, n_pad 5,120: the kernel path engages)."""
    lines = corpus_lines()
    ents = [hg.add_entity(f"entity {i}", ln) for i, ln in enumerate(lines)]
    n_top = -(-len(ents) // 64)
    for t in range(n_top):
        s = hg.add_summary(t, f"Topic {t}", " ".join(lines[64 * t:64 * t + 2]))
        for e in ents[64 * t:64 * t + 64]:
            hg.add_belongs_to(e, s)
    for c in range(-(-n_top // 8)):
        s = hg.add_summary(n_top + c, f"Community {c}", f"topics {8 * c} to {8 * c + 7}",
                           level=2)
        for t in range(8 * c, min(8 * c + 8, n_top)):
            hg.add_belongs_to(f"sum:{t}", s)
    return hg


def xl_paragraphs() -> list:
    """(title, text) of the 1,835 paragraphs of the shared-KB XL dev world."""
    text = (SAMPLES / "synth_v4_sharedxl_corpus_dev.txt").read_text()
    out = []
    for block in text.split("=== ")[1:]:
        title, body = block.split(" ===", 1)
        out.append((title.strip(), " ".join(body.split())))
    return out


def xl_questions() -> list:
    """The 150 questions of the shared-KB XL dev split, as dicts."""
    path = SAMPLES / "synth_v4_sharedxl_dev.jsonl"
    return [json.loads(ln) for ln in path.read_text().splitlines() if ln.strip()]


def xl_graph(hg):
    """The XL dev world as a graph: each paragraph an entity named by its
    title with the paragraph as its description, under topic summaries of 64
    members and communities of 8 topics (1,868 nodes, n_pad under 4,096: the
    seed stage is the small-corpus float32 product, no kernel)."""
    paras = xl_paragraphs()
    titles = [t for t, _ in paras]
    n_top = -(-len(paras) // 64)
    ents = [hg.add_entity(t, body, l1_parents={str(i // 64): 1.0})
            for i, (t, body) in enumerate(paras)]
    for t in range(n_top):
        s = hg.add_summary(t, f"Topic {t}", " ".join(b for _, b in paras[64 * t:64 * t + 2]),
                           members=titles[64 * t:64 * t + 64])
        for e in ents[64 * t:64 * t + 64]:
            hg.add_belongs_to(e, s)
    for c in range(-(-n_top // 8)):
        tops = range(8 * c, min(8 * c + 8, n_top))
        s = hg.add_summary(n_top + c, f"Community {c}", f"topics {8 * c} to {tops[-1]}",
                           members=[f"sum:{t}" for t in tops], level=2)
        for t in tops:
            hg.add_belongs_to(f"sum:{t}", s)
    return hg


@contextlib.contextmanager
def scratch_cwd():
    """Work in a fresh temporary directory, removed afterwards: the answer path
    writes each answer's session files under ``artifacts/sessions/`` of the
    working directory, and finds no ``configs/ahrag.yaml`` there (the defaults,
    as on a machine without PyYAML)."""
    import tempfile
    old = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        yield tmp
        os.chdir(old)


ANSWER_KEYS = ("query", "answer", "rationale", "citations", "retrieved_nodes")


def same_answer(a: dict, b: dict) -> bool:
    """Two ``RetrievalService.answer`` results equal but for ``metrics.time_s``."""
    def strip(x):
        return {**x, "metrics": {k: v for k, v in x["metrics"].items() if k != "time_s"}}
    return strip(a) == strip(b)


def answer_record(svc, query: str) -> dict:
    """``svc.answer(query)``'s fields with the evidence ids and the context text
    of the full record its session saved (``answer.json``)."""
    sessions = Path("artifacts/sessions")
    before = set(os.listdir(sessions)) if sessions.exists() else set()
    out = svc.answer(query)
    new = set(os.listdir(sessions)) - before
    check(len(new) == 1, f"one new session per answer: {new}")
    rec = json.loads((sessions / new.pop() / "answer.json").read_text())
    return {**{k: out[k] for k in ANSWER_KEYS},
            "evidence": [e["node_id"] for key in ("summaries", "entities")
                         for e in rec["evidence"][key]],
            "context_text": rec["context"]["context_text"]}


def near_tie(card_hg, cpu_hg, query: str, tol: float = 1e-5) -> bool:
    """Whether a card/CPU difference on ``query`` comes from a near tie: a
    search the answer path makes (the anchor, top_k 5; the rescue, top_k 96)
    ranks other rows on the two devices, and at every rank where they differ
    the two devices' raw scores lie within ``tol`` of each other (two rows
    whose scores agree to ``tol`` traded places)."""
    from ahrag_tpu_torch.graph.search import hybrid_search
    for top_k in (5, 96):
        res = []
        for hg in (card_hg, cpu_hg):
            gt = hg.tensors()
            q = hg.encode_query_device([query])[0].to(gt.device)
            r = hybrid_search(gt, q, hg._resolve_weights(), top_k=top_k, member_top_m=5)
            res.append((r.reranked_idx.tolist(), r.reranked_score.tolist()))
        (ci, cs), (pi, ps) = res
        if ci != pi:
            return all(abs(cs[k] - ps[k]) <= tol for k in range(len(ci)) if ci[k] != pi[k])
    return False


def token_f1(pred: str, golds: list) -> float:
    """The best SQuAD-style token F1 of ``pred`` against any gold answer."""
    import re
    from collections import Counter

    def toks(x):
        return re.sub(r"\b(a|an|the)\b", " ", re.sub(r"[^\w\s]", " ", x.lower())).split()
    best = 0.0
    for g in golds:
        p, t = toks(pred or ""), toks(g)
        common = sum((Counter(p) & Counter(t)).values())
        if common:
            best = max(best, 2 * common / (len(p) + len(t)))
    return best


def http_json(base: str, path: str, obj=None) -> tuple:
    """(status, JSON body) of a GET (``obj`` None) or a JSON POST."""
    import urllib.request
    data = None if obj is None else json.dumps(obj).encode()
    req = urllib.request.Request(f"{base}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, json.loads(r.read())


def result_ids(results) -> list:
    return [[r["node_id"] for r in res] for res in results]


def phase_host_graph(dev) -> dict:
    """A real host graph on the card: ``corpus_graph`` built, indexed
    (``build_vector_index``, layers 0-2: IDF, associations, LSA), saved,
    loaded and served by a ``RetrievalService``. 64 and 256 sample questions
    through ``search_many`` (buckets 64 and 256: ``dense_binmax`` and
    ``dense_binmax2``) against the same service on the CPU and against
    ``hg.search`` on the card; then ``serve_http`` on port 0. Returns the
    launch counts of the two ``search_many`` calls (the main path)."""
    import tempfile
    import threading
    from ahrag_tpu_torch.graph import HierarchicalGraph
    from ahrag_tpu_torch.serve import RetrievalService, serve_http
    t0 = time.perf_counter()
    hg = corpus_graph(HierarchicalGraph(encoder_name="hashed", device=dev))
    hg.build_vector_index(layers=(0, 1, 2))
    index_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        hg.save(tmp)
        loaded = HierarchicalGraph.load(tmp, device=dev)
        svc_cpu = RetrievalService(graph_dir=tmp, device="cpu")
    svc = RetrievalService(hg=loaded, device=dev)
    n_pad = svc.gt.n_pad
    log(f"  {loaded.number_of_nodes()} nodes (n_pad {n_pad}), built and indexed in "
        f"{index_s:.1f}s; lsa {loaded._lsa is not None}, assoc in queries "
        f"{loaded.query_assoc() is not None}")
    check(loaded.number_of_nodes() == 4122 and n_pad == 5120, "graph size")
    qs = sample_questions(256)
    reset_counts()   # the main path: the service at buckets 64 and 256
    t0 = time.perf_counter()
    card64 = svc.search_many(qs[:64])
    t64 = time.perf_counter()
    card256 = svc.search_many(qs)
    t256 = time.perf_counter()
    counts = read_counts()
    cpu64, cpu256 = svc_cpu.search_many(qs[:64]), svc_cpu.search_many(qs)
    host = [loaded.search(q) for q in qs[:64]]
    score_err = max(abs(a["score"] - b["score"]) for x, y in zip(card64, host)
                    for a, b in zip(x, y))
    log(f"  search_many 64: {(t64 - t0) * 1e3:.1f} ms, 256: {(t256 - t64) * 1e3:.1f} ms "
        f"(first calls), launches {counts}; ids card == cpu at 64 "
        f"{result_ids(card64) == result_ids(cpu64)}, at 256 "
        f"{result_ids(card256) == result_ids(cpu256)}; == hg.search "
        f"{result_ids(card64) == result_ids(host)}, max|score diff| {score_err:.1e}")
    check(result_ids(card64) == result_ids(cpu64), "bucket 64: card ids differ from the CPU's")
    check(result_ids(card256) == result_ids(cpu256), "bucket 256: card ids differ from the CPU's")
    check(result_ids(card256[:64]) == result_ids(card64), "buckets 64 and 256 differ")
    check(result_ids(card64) == result_ids(host) and score_err <= 1e-4,
          f"service against hg.search: score diff {score_err}")
    check(all(len(r) == 5 for r in card256), "five results per question")

    server = serve_http(svc, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    health = http_json(base, "/healthz")
    one = http_json(base, "/search", {"query": qs[0]})
    three = http_json(base, "/search", {"queries": qs[:3]})
    beam = http_json(base, "/beam", {"query": qs[0], "beam_width": 8, "depth": 3,
                                     "top_k": 10})
    with scratch_cwd():          # the answers' session files go to a directory removed after
        reset_counts()
        answers = [http_json(base, "/answer", {"query": q}) for q in qs[:2]]
        answer_counts = read_counts()
        want_answers = [svc.answer(q) for q in qs[:2]]
    stats = http_json(base, "/stats")
    server.shutdown()
    server.server_close()
    thread.join(timeout=30)
    want_beam = [r["node_id"] for r in svc.beam(qs[0], beam_width=8, depth=3, top_k=10)]
    statuses = [health[0], one[0], three[0], beam[0], *(a[0] for a in answers), stats[0]]
    log(f"  HTTP /healthz /search(1) /search(3) /beam /answer(2) /stats: {statuses}; beam ids "
        f"{[r['node_id'] for r in beam[1]['results']][:4]}...; answers "
        f"{[a[1]['answer'] for a in answers]}, launches {answer_counts}")
    check(statuses == [200] * 7 and health[1]["nodes"] == 4122, f"HTTP statuses {statuses}")
    for (_, got), want in zip(answers, want_answers):
        check(same_answer(got, want), f"HTTP /answer differs from svc.answer: {got} {want}")
    check(result_ids(one[1]["results"]) == result_ids(card64[:1]), "HTTP /search one query")
    check(result_ids(three[1]["results"]) == result_ids(card64[:3]), "HTTP /search three")
    check([r["node_id"] for r in beam[1]["results"]] == want_beam and want_beam,
          "HTTP /beam ids")
    check("search_finalize" in stats[1]["timers"], "HTTP /stats timers")
    svc.close()
    svc_cpu.close()
    return {"index_s": index_s, "launches": counts, "answer_launches": answer_counts,
            "n_pad": n_pad,
            "search_many_ms": {"64": (t64 - t0) * 1e3, "256": (t256 - t64) * 1e3}}, \
        loaded, svc_cpu.hg


class LazyNodes(dict):
    """node id ``n<i>`` -> node dict of the bench graph, made at first access
    (result assembly reads only the returned ids), with the judge and
    confidence the graph's tensors hold."""

    def __init__(self, arrs):
        super().__init__()
        self._arrs = arrs

    def __missing__(self, key):
        import math
        a, i = self._arrs, int(key[1:])
        if a.node_type[i] == 0:
            d = {"node_type": "entity", "name": f"Node {i}",
                 "description": f"synthetic entity {i}"}
        else:
            d = {"node_type": "summary", "level": int(a.level[i]),
                 "title": f"Summary {i}", "summary_text": "synthetic summary"}
            if not math.isnan(a.judge[i]):
                d["judge_scores"] = {"overall": float(a.judge[i])}
            if not math.isnan(a.conf[i]):
                d["confidence"] = float(a.conf[i])
        self[key] = d
        return d

    def get(self, key, default=None):
        return self[key]


def bench_service(dev, gt, arrs, **kw):
    """A ``RetrievalService`` over a bench rung's ``GraphTensors``: the host
    graph is a shim whose node table is built lazily (``LazyNodes``), since
    serving reads only the tensors, the id table and the returned nodes."""
    from ahrag_tpu_torch.graph import HierarchicalGraph
    from ahrag_tpu_torch.serve import RetrievalService
    hg = HierarchicalGraph(encoder_name="hashed", device=dev)
    hg.nodes = LazyNodes(arrs)
    hg._tensors = gt
    hg._idx_to_id = [f"n{i}" for i in range(arrs.n)]
    hg._embeddings = {"n0": arrs.emb[0]}   # indexed: nothing to (re)build
    hg.vector_index["indexed_nodes"] = arrs.n
    return RetrievalService(hg=hg, device=dev, **kw)


# (closed-loop callers, requests per caller) of each phase 9 load: at least
# 1,024 requests per load, so p99 is not the largest sample
SERVICE_LOADS = ((1, 1024), (32, 64), (256, 32))
P99_MIN_REQUESTS = 1000


def phase_service_1m(dev, gt, gt_cpu, arrs, loads=SERVICE_LOADS) -> dict:
    """The service at full width: the 1M-node bf16 rung behind
    ``RetrievalService(max_batch=512, max_wait_s=0.003)``, driven by
    ``run_load`` at each (callers, requests per caller) of ``loads``; per
    load the requests, window, qps, p50/p95/p99/max (p99 only over at least
    ``P99_MIN_REQUESTS`` requests), mean batch, errors and the stage timers.
    Then the ids of 1, 4, 16 and 256 texts (buckets 1, 4, 16 and 256:
    ``dense_binmax`` and ``dense_binmax2``) through ``search_many`` against
    the same service built with ``device="cpu"`` over the same tensors, and
    of the 4 texts against a direct ``pack_queries`` + ``encode_and_search``
    with the service's own staged projection and idf. Last, 8 batches at
    bucket 256 timed without and then under ``profiling.trace``. Returns the
    launch counts of the loads (the main path), the per-load rows and the
    trace's top ops."""
    import os
    import torch
    from ahrag_tpu_torch.cli.serve_bench import run_load
    from ahrag_tpu_torch.serve import encode_and_search, pack_queries
    from ahrag_tpu_torch.utils import profiling
    svc = bench_service(dev, gt, arrs, max_batch=512, max_wait_s=0.003)
    qs = sample_questions(256)
    reset_counts()   # the main path: the service under load
    rows = []
    for threads, requests in loads:
        before = svc._batcher.stats()
        rep = run_load(svc, qs, threads=threads, requests_per_thread=requests)
        after = svc._batcher.stats()
        batches = after["batches"] - before["batches"]
        timers = svc.timers.snapshot()
        lat = rep["latency_ms"]
        row = {"callers": threads, "requests": rep["requests"], "window_s": rep["wall_s"],
               "qps": rep["qps"], "p50_ms": lat.get("p50_ms"), "p95_ms": lat.get("p95_ms"),
               "p99_ms": lat.get("p99_ms") if rep["requests"] >= P99_MIN_REQUESTS else None,
               "max_ms": lat.get("max_ms"),
               "mean_batch": (after["items"] - before["items"]) / max(1, batches),
               "batches": batches, "errors": rep["errors"],
               "stage_mean_ms": {k: v["mean_s"] * 1e3 for k, v in timers.items()},
               "stage_count": {k: v["count"] for k, v in timers.items()}}
        rows.append(row)
        log(f"  load {json.dumps(row)}")
        check(rep["errors"] == 0, f"{threads} callers: {rep['errors']} errors")
    counts = read_counts()
    texts = ["who directed the 1994 biographical film ed wood",
             "american superhero film directed by scott derrickson",
             "hierarchical retrieval over topic summaries",
             "community of film directors and their works"]
    svc_cpu = bench_service(torch.device("cpu"), gt_cpu, arrs, max_batch=512)
    for batch in ([texts[0]], texts, qs[:16], qs):
        card = svc.search_many(batch)
        t0 = time.perf_counter()
        cpu = svc_cpu.search_many(batch)
        score_err = max(abs(a["score"] - b["score"]) for x, y in zip(card, cpu)
                        for a, b in zip(x, y))
        same = result_ids(card) == result_ids(cpu)
        log(f"  bucket {svc._bucket(len(batch))}: ids card == cpu {same}, max|score "
            f"diff| {score_err:.1e} (entries rounded to 1e-4), cpu "
            f"{(time.perf_counter() - t0) * 1e3:.0f} ms")
        check(same and all(card), f"bucket {len(batch)}: card ids differ from the CPU's")
    svc_cpu.close()
    served = result_ids(svc.search_many(texts))
    n, n_rows, packed = pack_queries(texts, svc._enc)
    direct = encode_and_search(packed, svc._proj_dev, svc._idf_dev, svc.gt, svc._w_cached,
                               n_rows=n_rows, top_k=5, member_top_m=5).cpu()
    direct_ids = [[f"n{int(i)}" for i, ok in zip(r[:, 0].tolist(), r[:, 3].tolist()) if ok]
                  for r in direct[:n]]
    log(f"  4 texts: service ids {served[0]}... == direct {served == direct_ids}")
    check(served == direct_ids, "service ids differ from pack_queries + encode_and_search")
    logdir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "traces", "serve_1m")
    svc.search_many(qs)

    def eight_batches():
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(8):
            svc.search_many(qs)
        torch.cuda.synchronize(dev)
        return (time.perf_counter() - t0) * 1e3

    plain_wall_ms = eight_batches()
    with profiling.trace(logdir) as prof:
        wall_ms = eight_batches()
    # kernels (device-side events) by their device time; the ops that launch
    # them by the device time of their own launches
    avgs = prof.key_averages()
    kernels = sorted((e for e in avgs if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    ops = sorted((e for e in avgs if e.device_type == torch.autograd.DeviceType.CPU
                  and e.self_device_time_total > 0), key=lambda e: -e.self_device_time_total)
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = [[e.key[:60], round(e.self_device_time_total / 1e3, 3), e.count] for e in kernels[:10]]
    top_ops = [[e.key, round(e.self_device_time_total / 1e3, 3), e.count] for e in ops[:10]]
    log(f"  8 batches at bucket 256: wall {plain_wall_ms:.1f} ms untraced, {wall_ms:.1f} ms "
        f"traced (written to {logdir}); kernels {device_ms:.1f} ms: the card busy "
        f"{device_ms / plain_wall_ms:.1%} of the untraced wall "
        f"({device_ms / wall_ms:.1%} of the traced)")
    log(f"  top 10 kernels by device time [name, ms, launches]: {json.dumps(top)}")
    log(f"  top 10 ops by the device time they launch [op, ms, calls]: {json.dumps(top_ops)}")
    svc.close()
    return {"launches": counts, "loads": rows, "trace": {
        "wall_ms": wall_ms, "untraced_wall_ms": plain_wall_ms, "device_ms": device_ms,
        "top_kernels": top, "top_ops": top_ops}}


# the scripted deterministic policy of phase 10: the action for
# each observation's env step field (obs[:, 0]); together the six steps of an
# episode take actions 0-5 (a masked choice falls to end)
AGENT_SCHEDULE = (0, 0, 3, 1, 2, 4, 5, 5)
AGENT_BATCHES = (512, 16)        # dense_binmax2 (B % 128 == 0) and dense_binmax


def scripted_policy(obs):
    """Logits one-hot x 1e4 at ``AGENT_SCHEDULE[step]``, value 0."""
    import torch
    sched = torch.tensor(AGENT_SCHEDULE, device=obs.device)
    a = sched[obs[:, 0].long().clamp(0, len(AGENT_SCHEDULE) - 1)]
    return (torch.nn.functional.one_hot(a, 6).float() * 1e4,
            torch.zeros(obs.shape[0], device=obs.device))


def random_policy(obs):
    """``collect_trajectories.collect_device``'s policy: uniform logits."""
    import torch
    return (torch.zeros(obs.shape[0], 6, device=obs.device),
            torch.zeros(obs.shape[0], device=obs.device))


def check_rollout(what, traj, policy):
    """Masked actions never taken, ``logps`` the masked log-softmax at the
    taken action, ``values`` a direct forward of the stored observations,
    every first step live. Returns the largest logp and value differences."""
    import torch
    from ahrag_tpu_torch.agent.vec_env import N_ACTIONS
    obs = traj.obs.reshape(-1, traj.obs.shape[-1])
    has_top = traj.obs[..., 4:7].sum(-1) > 0              # first node block's type one-hot
    check(bool(((traj.actions == N_ACTIONS - 1) | has_top | ~traj.mask).all()),
          f"{what}: a masked action was taken")
    check(bool(traj.mask[:, 0].all()), f"{what}: a first step was not live")
    with torch.no_grad():
        logits, value = policy(obs)
    mask = has_top.reshape(-1, 1) | (torch.arange(N_ACTIONS, device=obs.device) == N_ACTIONS - 1)
    logp = torch.log_softmax(torch.where(mask, logits, -1e9), -1).gather(
        1, traj.actions.reshape(-1, 1).long())[:, 0]
    lp_err = (logp - traj.logps.reshape(-1)).abs().max().item()
    v_err = (value - traj.values.reshape(-1)).abs().max().item()
    check(lp_err <= 1e-5 and v_err <= 1e-5,
          f"{what}: logps differ by {lp_err}, values by {v_err}")
    check(all(bool(torch.isfinite(x).all()) for x in (traj.obs, traj.rewards, traj.logps)),
          f"{what}: finite trajectory")
    return lp_err, v_err


def hyperedge_graph(d: int, device):
    """A bench hierarchy of 4,072 nodes plus 512 hyperedges of three entities
    each (every entity in up to two), with entity-entity related links:
    4,584 nodes, n_pad 5,120, so the seed kernels run, and ``related``,
    ``hyperedges`` and ``members`` all have entries. Returns (tensors, 64
    queries near hyperedge members)."""
    import numpy as np
    from ahrag_tpu_torch.bench_data import build_bench_arrays
    from ahrag_tpu_torch.graph.tensors import build_graph_tensors
    a = build_bench_arrays(4000, 64, d=d, seed=13)
    rng = np.random.default_rng(13)
    n0, H = a.n, 512
    groups = np.concatenate([rng.permutation(a.n_entities)[:768].reshape(256, 3),
                             rng.permutation(a.n_entities)[:768].reshape(256, 3)])
    hemb = a.emb[groups].sum(1)
    hemb /= np.linalg.norm(hemb, axis=1, keepdims=True)
    hyper = {}
    for h, g in enumerate(groups):
        for e in g:
            hyper.setdefault(int(e), []).append(n0 + h)
    members = {n0 + h: [int(e) for e in g] for h, g in enumerate(groups)}
    related = {i: [int(x) for x in row if x >= 0] for i, row in enumerate(a.related_ell)}
    for i in range(0, a.n_entities - 1, 5):
        related.setdefault(i, []).append(i + 1)
        related.setdefault(i + 1, []).append(i)

    def ext(ell):
        return np.concatenate([ell, np.full((H, ell.shape[1]), -1, np.int32)])

    gt = build_graph_tensors(
        embeddings=np.concatenate([a.emb, hemb]).astype(np.float32),
        node_types=np.concatenate([a.node_type, np.full(H, 2, np.int32)]),
        levels=np.concatenate([a.level, np.zeros(H, np.int32)]),
        judges=np.concatenate([a.judge, np.full(H, np.nan)]),
        confs=np.concatenate([a.conf, 5.0 + np.arange(H) % 4]),
        indexed=np.ones(n0 + H, bool), parents=ext(a.parents_ell),
        children=ext(a.children_ell), related=related, hyperedges=hyper,
        members=members, emb_dtype="float32", device=device)
    picks = groups[rng.integers(0, H, 64), rng.integers(0, 3, 64)]
    q = a.emb[picks] + 0.3 * rng.standard_normal((64, d)).astype(np.float32)
    return gt, (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)


def small_graphs(d: int, device, g: int = 8):
    """``g`` bench graphs of 300-1,000 entities (under 4,096 rows each), one
    query per graph."""
    import numpy as np
    from ahrag_tpu_torch.bench_data import bench_queries, bench_tensors, build_bench_arrays
    gts, qs = [], []
    for i in range(g):
        arrs = build_bench_arrays(300 + 100 * i, 8 + 4 * i, d=d, seed=20 + i)
        gts.append(bench_tensors(arrs, "float32", device=device))
        qs.append(bench_queries(arrs, 1, seed=30 + i)[0])
    return gts, np.stack(qs)


def phase_agent(dev, r1, gt_cpu, smi: str) -> dict:
    """The agent at 1M nodes (phase 3's bf16 tensors, D = 384, max_steps 6):
    rollouts, card against CPU, anchors, a hyperedge graph, the sync guard,
    PPO training and multi-graph rollouts. Returns the main path's launch
    counts (the rollouts and the training) and the times."""
    import os
    import numpy as np
    import torch
    from ahrag_tpu_torch.agent import vec_env as ve
    from ahrag_tpu_torch.agent.featurizer import OBS_DIM
    from ahrag_tpu_torch.agent.ppo import (PPOConfig, PPOLearner, gae_device,
                                           make_train_step, ppo_train_device)
    from ahrag_tpu_torch.graph.multi import (hybrid_search_multi, rollout_multi,
                                             stack_graph_tensors)
    from ahrag_tpu_torch.graph.search import SearchWeights, hybrid_search_batch
    from ahrag_tpu_torch.models.policy.nets import ActorCritic
    gt, w, q_all = r1["gt"], r1["w"], r1["q_dev"][:512].contiguous()
    n_pad = gt.n_pad
    launches = {k: 0 for k in read_counts()}

    def counted(fn):
        reset_counts()
        out = fn()
        torch.cuda.synchronize(dev)
        for k, v in read_counts().items():
            launches[k] += v
        return out

    ac = ActorCritic(OBS_DIM, ve.N_ACTIONS, seed=0, device=dev)
    times, rollouts = {}, {}
    for B in AGENT_BATCHES:
        q = q_all[:B]
        for name, policy in (("actor_critic", ac), ("random", random_policy)):
            gen = torch.Generator(device=dev).manual_seed(B)
            before = dict(launches)
            traj, final = counted(lambda: ve.rollout_batch(gt, q, policy, w, max_steps=6,
                                                           generator=gen))
            lp_err, v_err = check_rollout(f"B={B} {name}", traj, policy)
            used = {k: launches[k] - before[k] for k in launches}
            rollouts[f"B={B} {name}"] = {
                "live_steps": int(traj.mask.sum()), "actions": torch.bincount(
                    traj.actions[traj.mask].long(), minlength=6).tolist(),
                "mean_ep_reward": float((traj.rewards * traj.mask).sum() / B),
                "selected": int(final.sel_count.sum()), "launches": used,
                "logp_err": lp_err, "value_err": v_err}
        kernel = "binmax2_cuda" if B % 128 == 0 else "binmax_cuda"
        check(rollouts[f"B={B} actor_critic"]["launches"][kernel] > 0,
              f"B={B}: {kernel} launched by the rollout's reset")
        state0 = ve.env_reset(gt, q, w)
        act = torch.full((B,), 2, dtype=torch.int64, device=dev)
        gen = torch.Generator(device=dev).manual_seed(0)
        reset_ms = cuda_ms(lambda: ve.env_reset(gt, q, w), 10)
        step_ms = cuda_ms(lambda: ve.env_step(gt, state0, act), 20)
        obs_ms = cuda_ms(lambda: ve.observe(gt, state0), 20)
        roll_ms = cuda_ms(lambda: ve.rollout_batch(gt, q, ac, w, max_steps=6, generator=gen), 5)
        times[f"B={B}"] = {"env_reset_ms": reset_ms, "env_step_ms": step_ms,
                           "observe_ms": obs_ms, "rollout_ms": roll_ms,
                           "episodes_per_s": B / roll_ms * 1e3}
    log(f"  rollouts (6 steps): {json.dumps(rollouts)}")
    # where a rollout's time goes: its kernels' device time against its wall
    from ahrag_tpu_torch.utils import profiling
    gen = torch.Generator(device=dev).manual_seed(0)
    with profiling.trace(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                      "traces", "agent_1m")) as prof:
        ve.rollout_batch(gt, q_all, ac, w, max_steps=6, generator=gen)
        torch.cuda.synchronize(dev)
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kern) / 1e3
    times["trace B=512"] = {
        "kernel_ms": device_ms, "kernel_launches": sum(e.count for e in kern),
        "busy_share_of_untraced_rollout": device_ms / times["B=512"]["rollout_ms"],
        "top_kernels": [[e.key[:60], round(e.self_device_time_total / 1e3, 3), e.count]
                        for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:5]]}

    # the reset's anchors are hybrid search's certified reranked ids
    st = ve.env_reset(gt, q_all, w)
    res = hybrid_search_batch(gt, q_all, w, top_k=5, member_top_m=5, certify=True)
    check(torch.equal(st.top_ids[:, :5].long(), res.reranked_idx)
          and bool((st.top_ids[:, 5:] == n_pad).all()),
          "env_reset's top ids differ from certified hybrid search at B=512")

    # no host sync inside a step or an observation
    act = torch.randint(0, 6, (512,), device=dev, generator=torch.Generator(device=dev)
                        .manual_seed(1))
    torch.cuda.synchronize(dev)
    torch.cuda.set_sync_debug_mode("error")
    st2, _, _ = ve.env_step(gt, st, act)
    ve.observe(gt, st2)
    torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize(dev)

    # card against CPU: the scripted policy on 64 lanes, over phase 6's CPU tensors
    q64 = q_all[:64]
    tc, fc = ve.rollout_batch(gt, q64, scripted_policy, w, max_steps=6)
    tp, fp = ve.rollout_batch(gt_cpu, q64.cpu(), scripted_policy,
                              SearchWeights.create(device="cpu"), max_steps=6)
    for name in ("actions", "rewards", "dones", "mask"):
        check(torch.equal(getattr(tc, name).cpu(), getattr(tp, name)),
              f"scripted rollout: {name} card != CPU")
    for name in ("top_ids", "n_seeds", "obs_sel_size", "obs_frontier_size", "step",
                 "gym_step", "done", "last_action", "sel_count", "front_count",
                 "selection", "frontier"):
        check(torch.equal(getattr(fc, name).cpu(), getattr(fp, name)),
              f"scripted rollout: final {name} card != CPU")
    obs_err = (tc.obs.cpu() - tp.obs).abs().max().item()
    check(obs_err <= 1e-5, f"scripted rollout: observations differ by {obs_err}")
    taken = torch.bincount(tc.actions[tc.mask].long(), minlength=6).tolist()
    check(all(taken[:6]), f"scripted rollout takes actions 0-5: {taken}")

    # a graph with hyperedges: related and LCA steps, card against CPU
    hg_dev, hq = hyperedge_graph(gt.dim, dev)
    hg_cpu, _ = hyperedge_graph(gt.dim, "cpu")
    wc = SearchWeights.create(device="cpu")
    sc = ve.env_reset(hg_dev, torch.from_numpy(hq).to(dev), w)
    sp = ve.env_reset(hg_cpu, torch.from_numpy(hq), wc)
    hyper_seen = 0
    for a in (1, 2, 6, 2, 0, 6, 1, 2, 6, 3):   # children first: entities on top
        acts = torch.full((64,), a, dtype=torch.int64)
        sc, rc, _ = ve.env_step(hg_dev, sc, acts.to(dev), enable_lca=True)
        sp, rp, _ = ve.env_step(hg_cpu, sp, acts, enable_lca=True)
        check(torch.equal(sc.top_ids.cpu(), sp.top_ids) and torch.equal(rc.cpu(), rp),
              f"hyperedge graph, action {a}: ids or rewards card != CPU")
        ids = sp.top_ids[sp.top_ids < hg_cpu.n_pad].long()
        hyper_seen += int((hg_cpu.node_type[ids] == 2).sum()) if a == 2 else 0
    check(torch.equal(sc.selection.cpu(), sp.selection)
          and torch.equal(sc.frontier.cpu(), sp.frontier), "hyperedge graph: masks")
    check(hyper_seen > 0, "expand_related reached no hyperedge")

    # training at full width: 3 updates of 512 episodes, saved and reloaded
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "artifacts",
                           "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "ppo_1m.pt")
    curve_path = os.path.join(out_dir, "ppo_1m_curve.json")
    t0 = time.perf_counter()
    learner = counted(lambda: ppo_train_device(
        gt, q_all, w, n_updates=3, max_steps=6, batch_size=512, save_path=path,
        log=lambda s: None, curve_out=curve_path))
    train_s = time.perf_counter() - t0
    curve = json.loads(open(curve_path).read())["curve"]
    check(len(curve) == 3 and all(np.isfinite(v) for c in curve for k, v in c.items()),
          f"ppo_train_device curve: {curve}")
    loaded = PPOLearner.load(path, device=dev)
    x = torch.randn(32, OBS_DIM, device=dev, generator=torch.Generator(device=dev).manual_seed(2))
    with torch.no_grad():
        check(all(torch.equal(u, v) for u, v in zip(learner.model(x), loaded.model(x))),
              "reloaded policy's logits differ")
    traj, _ = ve.rollout_batch(gt, q_all, learner.model, w, max_steps=6)
    adv, ret = gae_device(traj.rewards, traj.values, traj.dones, traj.mask)
    live = traj.mask.reshape(-1)
    data = (traj.obs.reshape(-1, OBS_DIM)[live], traj.actions.reshape(-1)[live],
            traj.logps.reshape(-1)[live], ret.reshape(-1)[live], adv.reshape(-1)[live])
    update_ms = cuda_ms(lambda: learner.update(*data), 3)
    step_fn = make_train_step(PPOLearner(OBS_DIM, ve.N_ACTIONS, PPOConfig(), device=dev), w)
    train_step_ms = cuda_ms(lambda: step_fn(gt, q_all), 3)
    times["train"] = {"ppo_train_device_3_updates_s": train_s, "update_ms": update_ms,
                      "update_rows": int(live.sum()), "train_step_ms": train_step_ms}

    # many graphs: anchors against per-graph search, then a rollout
    gts, mq = small_graphs(gt.dim, dev)
    bgt = stack_graph_tensors(gts)
    mq_dev = torch.from_numpy(mq).to(dev)
    mres = hybrid_search_multi(bgt, mq_dev, w, certify=False)
    for g, one_gt in enumerate(gts):
        one = hybrid_search_batch(one_gt, mq_dev[g:g + 1], w, certify=False)
        ok = one.reranked_valid[0]
        check(torch.equal(mres.reranked_valid[g], ok)
              and torch.equal(mres.reranked_idx[g][ok], one.reranked_idx[0][ok]),
              f"multi-graph anchor of graph {g} differs from its own search")
    mtraj, _ = rollout_multi(bgt, mq_dev, ac, w, max_steps=6,
                             generator=torch.Generator(device=dev).manual_seed(3))
    first = ve.observe(bgt, ve.reset_from_search(mres, bgt.n_pad,
                                                 graph=torch.arange(len(gts), device=dev)))
    check(torch.equal(mtraj.obs[:, 0], first), "rollout_multi starts from its anchors")
    check_rollout("multi-graph", mtraj, ac)
    times["multi"] = {"graphs": len(gts), "n_pad": bgt.n_pad,
                      "rollout_ms": cuda_ms(lambda: rollout_multi(bgt, mq_dev, ac, w), 5)}
    log(f"  agent times ({smi}): {json.dumps(times)}")
    log(f"  card == CPU on 64 scripted lanes (obs max diff {obs_err:.1e}, actions {taken}); "
        f"hyperedge graph n_pad {hg_dev.n_pad}: ids equal over related/LCA steps, "
        f"{hyper_seen} hyperedge ids expanded; main-path launches {launches}")
    return {"launches": launches, "times": times, "rollouts": rollouts, "curve": curve}


HOST_GRAPH_QUESTIONS = 32      # answers over phase 8's graph (the kernel path)
XL_ANSWER_QUESTIONS = 96       # phase 11: XL dev questions answered (of 150; cut for phase 14)


def timed_answers(svc, queries) -> tuple:
    """(answer records, host ms per answer) of ``queries`` through ``svc``;
    each answer ends in host reads of its searches' results."""
    out, ms = [], []
    for q in queries:
        t0 = time.perf_counter()
        out.append(answer_record(svc, q))
        ms.append((time.perf_counter() - t0) * 1e3)
    return out, ms


def compare_answers(what, card, cpu, queries, card_hg, cpu_hg) -> int:
    """Card answers against CPU answers, field by field. A question whose
    answers differ passes only as a near tie (``near_tie``), and is counted;
    any other difference fails. Returns the count of near ties."""
    ties = 0
    for q, a, b in zip(queries, card, cpu):
        if a != b:
            diff = [k for k in a if a[k] != b[k]]
            check(near_tie(card_hg, cpu_hg, q),
                  f"{what}: card and CPU differ in {diff} on {q!r}, not at a near tie")
            ties += 1
    return ties


def pcts(ms) -> dict:
    import numpy as np
    return {"p50_ms": float(np.percentile(ms, 50)), "p95_ms": float(np.percentile(ms, 95)),
            "max_ms": float(max(ms)), "mean_ms": float(np.mean(ms)), "n": len(ms)}


def phase_answers(dev, host_hg, host_hg_cpu) -> dict:
    """Question answering on the card. The XL dev world (``xl_graph``, 1,868
    nodes) built and indexed by the port on the card, saved and loaded onto the
    CPU; its first ``XL_ANSWER_QUESTIONS`` dev questions through
    ``RetrievalService.answer`` on the card
    and on the CPU, answer, rationale,
    citations, retrieved nodes, evidence ids and context text equal; per-answer
    latency, searches per answer, gold containment and token F1; the card's
    busy share over 16 warm answers: kernel time in a ``torch.profiler`` trace
    (``traces/answer_xl/``) over the wall of the same answers untraced. Then ``HOST_GRAPH_QUESTIONS`` shared-KB questions
    over phase 8's 4,122-node graph, card against CPU, whose one-query
    searches go through ``dense_binmax``. Returns the launch counts of the
    card's answers (the main path)."""
    import tempfile
    import torch
    from ahrag_tpu_torch.graph import HierarchicalGraph
    from ahrag_tpu_torch.serve import RetrievalService
    from ahrag_tpu_torch.utils import profiling
    items = xl_questions()[:XL_ANSWER_QUESTIONS]
    qs = [it["question"] for it in items]
    t0 = time.perf_counter()
    xl = xl_graph(HierarchicalGraph(encoder_name="hashed", device=dev))
    xl.build_vector_index(layers=(0, 1, 2))
    index_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        xl.save(tmp)
        xl_cpu = HierarchicalGraph.load(tmp, device="cpu")
    svc, svc_cpu = RetrievalService(hg=xl, device=dev), RetrievalService(hg=xl_cpu,
                                                                          device="cpu")
    n_pad = svc.gt.n_pad
    log(f"  XL world: {xl.number_of_nodes()} nodes (n_pad {n_pad}), built and indexed "
        f"on the card in {index_s:.1f}s, saved and loaded onto the CPU")
    check(xl.number_of_nodes() == 1868 and n_pad < 4096, "XL graph size")
    searches = [0]
    inner = xl.search

    def counted_search(*a, **kw):
        searches[0] += 1
        return inner(*a, **kw)
    xl.search = counted_search
    with scratch_cwd():
        reset_counts()
        card, card_ms = timed_answers(svc, qs)
        xl_counts = read_counts()
        n_search = searches[0]
        cpu, cpu_ms = timed_answers(svc_cpu, qs)
        ties = compare_answers("XL", card, cpu, qs, xl, xl_cpu)
        logdir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "traces",
                              "answer_xl")

        def sixteen_answers():
            torch.cuda.synchronize(dev)
            t1 = time.perf_counter()
            for q in qs[:16]:
                svc.answer(q)
            torch.cuda.synchronize(dev)
            return (time.perf_counter() - t1) * 1e3

        # the busy share divides the trace's kernel time by the wall of the
        # same warm work untraced (the first pass above also built the graph's
        # coverage index)
        untraced_ms = sixteen_answers()
        with profiling.trace(logdir) as prof:
            traced_ms = sixteen_answers()
    kern = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kern) / 1e3
    gold = sum(any(g.lower() in (a["answer"] or "").lower() for g in it["answers"])
               for a, it in zip(card, items))
    f1 = sum(token_f1(a["answer"], it["answers"]) for a, it in zip(card, items)) / len(items)
    check(all(a["answer"] and a["context_text"] for a in card), "every XL answer non-empty")
    check(device_ms > 0, "the trace of 16 answers saw device work")
    log(f"  {len(qs)} XL answers on the card and on the CPU: card == CPU "
        f"({ties} near ties); per answer card {json.dumps(pcts(card_ms))}, CPU "
        f"{json.dumps(pcts(cpu_ms))}; {n_search / len(qs):.2f} searches per answer; "
        f"gold contained {gold}/{len(items)}, token F1 {f1:.3f}; launches {xl_counts}")
    log(f"  16 answers: {untraced_ms:.1f} ms untraced, {traced_ms:.1f} ms traced "
        f"({logdir}), kernels {device_ms:.2f} ms in {sum(e.count for e in kern)} launches: "
        f"the card busy {device_ms / untraced_ms:.2%} of the untraced wall "
        f"({device_ms / traced_ms:.2%} of the traced); first pass over the same 16 "
        f"{sum(card_ms[:16]):.1f} ms; top "
        f"{json.dumps([[e.key[:50], round(e.self_device_time_total / 1e3, 3), e.count] for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:5]])}")
    svc.close()
    svc_cpu.close()

    host_qs = sample_questions(HOST_GRAPH_QUESTIONS)
    hsvc = RetrievalService(hg=host_hg, device=dev)
    hsvc_cpu = RetrievalService(hg=host_hg_cpu, device="cpu")
    with scratch_cwd():
        reset_counts()
        hcard, hcard_ms = timed_answers(hsvc, host_qs)
        host_counts = read_counts()
        hcpu, hcpu_ms = timed_answers(hsvc_cpu, host_qs)
    host_ties = compare_answers("host graph", hcard, hcpu, host_qs, host_hg, host_hg_cpu)
    hsvc.close()
    hsvc_cpu.close()
    log(f"  {len(host_qs)} shared-KB answers over phase 8's graph (n_pad "
        f"{host_hg.tensors().n_pad}): card == CPU ({host_ties} near ties); per answer card "
        f"{json.dumps(pcts(hcard_ms))}, CPU {json.dumps(pcts(hcpu_ms))}; launches "
        f"{host_counts}")
    check(host_counts["binmax_cuda"] >= len(host_qs),
          f"at least one dense_binmax launch per answer: {host_counts}")
    launches = {k: xl_counts[k] + host_counts[k] for k in xl_counts}
    return {"launches": launches, "xl": {
        "nodes": xl.number_of_nodes(), "n_pad": n_pad, "index_s": index_s,
        "card": pcts(card_ms), "cpu": pcts(cpu_ms),
        "near_ties": ties, "searches_per_answer": n_search / len(qs),
        "gold_contained": gold, "token_f1": f1, "questions": len(qs),
        "trace": {"untraced_ms": untraced_ms, "traced_ms": traced_ms,
                  "first_pass_ms": sum(card_ms[:16]),
                  "device_ms": device_ms, "busy_share": device_ms / untraced_ms}},
        "host_graph": {"card": pcts(hcard_ms), "cpu": pcts(hcpu_ms),
                       "near_ties": host_ties, "launches": host_counts}}

XL_BENCH_QUESTIONS = 96        # phase 12: shared-KB dev questions (of 150; cut for phase 14)
PER_QUESTION_ITEMS = 32        # phase 12: per-question graphs (synth_v4_dev)
FLEET_ITEMS = 16               # phase 12: per-question graphs stacked
GATE_V4 = (90.0, 0.85)         # ``make gate-v4``'s F1 and faithfulness bars


def quiet(fn, *a, **kw):
    """``fn(*a, **kw)`` with its standard output dropped: the pipeline and the
    benchmark print each stage and a report table."""
    import io
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*a, **kw)


def same_build(card_dir: str, cpu_dir: str) -> dict:
    """The card's artifacts and saved graph against the CPU's: every artifact
    file byte for byte; the graph's ``structure.json`` and ``meta.json`` byte
    for byte, ``embeddings.npz``'s ids, IDF and associations equal, its
    embeddings and LSA basis (float32 products in each device's order) within
    1e-5. Returns the largest differences."""
    import numpy as np
    art = sorted(os.listdir(os.path.join(card_dir, "artifacts")))
    check(art == sorted(os.listdir(os.path.join(cpu_dir, "artifacts"))) and len(art) >= 9,
          f"artifact files {art}")
    for rel in [f"artifacts/{a}" for a in art] + ["graph/structure.json", "graph/meta.json"]:
        check(Path(card_dir, rel).read_bytes() == Path(cpu_dir, rel).read_bytes(),
              f"{rel}: card and CPU files differ")
    za = np.load(os.path.join(card_dir, "graph", "embeddings.npz"))
    zb = np.load(os.path.join(cpu_dir, "graph", "embeddings.npz"))
    check(za.files == zb.files, f"embeddings.npz keys {za.files} vs {zb.files}")
    diffs = {}
    for k in za.files:
        if k in ("emb", "lsa"):
            diffs[k] = float(np.abs(za[k] - zb[k]).max())
            check(diffs[k] <= 1e-5, f"embeddings.npz {k} card vs CPU differ by {diffs[k]}")
        else:
            check(np.array_equal(za[k], zb[k]), f"embeddings.npz {k} card vs CPU differ")
    return {"artifact_files": art, "max_abs_diff": diffs}


def compare_rows(what, card, cpu, questions, answers, card_hg, cpu_hg) -> int:
    """``run_benchmark``'s rows card against CPU, and each answer's retrieved
    nodes (``answers[device][(system, question)]``): a difference passes only
    as a counted near tie (``near_tie``) of the question's searches on the two
    graphs. Returns the count of near ties."""
    card, cpu = card["items"], cpu["items"]
    check(len(card) == len(cpu) > 0, f"{what}: {len(card)} and {len(cpu)} rows")
    ties = 0
    for a, b in zip(card, cpu):
        key = (a["system"], questions[a["id"]])
        if a == b and answers["card"][key] == answers["cpu"][key]:
            continue
        diff = [k for k in a if a[k] != b.get(k)]
        check(near_tie(card_hg, cpu_hg, key[1]),
              f"{what}: card and CPU rows differ in {diff} (or retrieved nodes) on {key}, "
              "not at a near tie")
        ties += 1
    return ties


def phase_build(dev, ents_1m, ents_131k) -> tuple:
    """Build, answer and score on the card. (1) ``run_pipeline`` over the XL
    dev world on the card and on the CPU: stage seconds, node counts, n_pad,
    every artifact byte-equal and the saved graphs equal. (2)
    ``run_benchmark(system="both")`` over its first ``XL_BENCH_QUESTIONS`` dev
    questions, over the
    card's graph on the card and the CPU's on the CPU: rows and retrieved
    nodes equal (near ties counted), aggregate F1/EM/recall@10, per-question
    ms, at least one ``dense_binmax`` launch per ``ah_rag`` question. (3)
    ``run_benchmark(system="ah_rag")`` over the first 32 ``synth_v4_dev``
    items (a graph per question), card against CPU, and ``eval_gate``'s
    verdict at ``make gate-v4``'s bars (printed, not gated). (4)
    ``build_question_fleet`` over 16 of those items on the card and the CPU:
    stacked tensors, query vectors and gold masks equal (embeddings within
    1e-5), then one scripted ``rollout_multi`` over each stack, actions and
    rewards equal. (5) ``spherical_kmeans`` over the 1M rung's entity rows on
    the card (init and EM timed apart), and over the 131k rung's on the card
    and the CPU, assignments equal but counted near ties. Works in the
    current directory (the pipeline's files go under ``card/`` and ``cpu/``);
    returns (results, the card's and the CPU's XL graphs)."""
    import numpy as np
    import torch
    from ahrag_tpu_torch.agent.fleet import build_question_fleet
    from ahrag_tpu_torch.cli import benchmark as bench
    from ahrag_tpu_torch.cli.demo import run_pipeline
    from ahrag_tpu_torch.cli.eval_gate import verdict
    from ahrag_tpu_torch.graph import HierarchicalGraph
    from ahrag_tpu_torch.graph.multi import rollout_multi
    from ahrag_tpu_torch.graph.search import SearchWeights
    from ahrag_tpu_torch.ops.kmeans import (kmeans_em, kmeans_init, spherical_kmeans,
                                            unit_rows)
    out = {}
    devices = (("card", dev), ("cpu", torch.device("cpu")))
    # (1) the pipeline over the XL dev world, card and CPU
    corpus = str(SAMPLES / "synth_v4_sharedxl_corpus_dev.txt")
    stages, hgs = {}, {}
    for name, d in devices:
        stages[name] = {}
        t0 = time.perf_counter()
        hgs[name] = quiet(run_pipeline, corpus, f"{name}/artifacts", f"{name}/graph",
                          device=d, timings=stages[name])
        torch.cuda.synchronize(dev)
        stages[name]["total_s"] = time.perf_counter() - t0
    same = same_build("card", "cpu")
    stats = hgs["card"].stats()
    n_pad = hgs["card"].tensors().n_pad
    check(stats == hgs["cpu"].stats() and list(hgs["card"].nodes) == list(hgs["cpu"].nodes),
          "card and CPU graphs hold the same nodes")
    check(n_pad >= 4096, f"the pipeline's XL graph reaches the kernel path (n_pad {n_pad})")
    log(f"  XL build: {json.dumps(stats)}, n_pad {n_pad}; stage seconds card "
        f"{json.dumps(stages['card'])}, CPU {json.dumps(stages['cpu'])}; artifacts "
        f"byte-equal card == CPU ({len(same['artifact_files'])} files), graphs equal "
        f"(max |card - CPU| {json.dumps(same['max_abs_diff'])})")
    out["xl_build"] = {"stats": stats, "n_pad": n_pad, "stages": stages, **same}

    # (2) answer and score the dev questions over each device's graph
    items = xl_questions()[:XL_BENCH_QUESTIONS]
    questions = {it["id"]: it["question"] for it in items}
    answers = {"card": {}, "cpu": {}}
    system_ms = {"card": {}, "cpu": {}}     # host ms of each system's answers
    side = ["card"]
    inner = bench.run_system

    def recording(system, query, cfg, hg):
        t0 = time.perf_counter()
        ans = inner(system, query, cfg, hg)
        system_ms[side[0]].setdefault(system, []).append((time.perf_counter() - t0) * 1e3)
        answers[side[0]][(system, query)] = ans.get("retrieved_nodes", [])
        return ans
    bench.run_system = recording
    reports, ms = {}, {}
    data = str(SAMPLES / "synth_v4_sharedxl_dev.jsonl")
    for name, d in devices:
        ms[name], side[0] = [], name
        reset_counts()
        reports[name] = quiet(bench.run_benchmark, "local", system="both",
                              limit=XL_BENCH_QUESTIONS, data_path=data,
                              graph_dir=f"{name}/graph", device=d, item_ms=ms[name])
        if name == "card":
            torch.cuda.synchronize(dev)
            launches = read_counts()
    bench.run_system = inner
    ties = compare_rows("XL benchmark", reports["card"], reports["cpu"], questions, answers,
                        HierarchicalGraph.load("card/graph", device=dev),
                        HierarchicalGraph.load("cpu/graph", device="cpu"))
    agg = {r["system"]: {k: r[k] for k in ("n", "f1", "em", "retrieval_recall_at_10",
                                            "faithfulness", "overall_score")}
           for r in reports["card"]["aggregate"]}
    n_ah = sum(r["system"] == "ah_rag" for r in reports["card"]["items"])
    check(launches["binmax_cuda"] >= n_ah,
          f"at least one dense_binmax launch per ah_rag question: {launches}")
    split = {name: {system: pcts(v) for system, v in sorted(per.items())}
             for name, per in system_ms.items()}
    log(f"  {len(items)} XL questions x 2 systems over the pipeline's graph: card == CPU "
        f"({ties} near ties); aggregate {json.dumps(agg)}; per question (both systems "
        f"and their scores, 2 workers) card {json.dumps(pcts(ms['card']))}, CPU "
        f"{json.dumps(pcts(ms['cpu']))}; per answer by system {json.dumps(split)}; "
        f"launches {launches}")
    out["xl_benchmark"] = {"aggregate": agg, "near_ties": ties, "card": pcts(ms["card"]),
                           "cpu": pcts(ms["cpu"]), "by_system": split,
                           "launches": launches,
                           "by_qtype": reports["card"].get("by_qtype")}

    # (3) per-question graphs and the v4 gate
    pq = str(SAMPLES / "synth_v4_dev.jsonl")
    pq_reports, pq_ms = {}, {}
    for name, d in devices:
        pq_ms[name] = []
        pq_reports[name] = quiet(bench.run_benchmark, "local", system="ah_rag",
                                 limit=PER_QUESTION_ITEMS, data_path=pq, device=d,
                                 item_ms=pq_ms[name])
    check(pq_reports["card"] == pq_reports["cpu"],
          "per-question graphs: card and CPU reports differ")
    gate = verdict(pq_reports["card"], *GATE_V4)
    pq_agg = pq_reports["card"]["aggregate"][0]
    log(f"  {PER_QUESTION_ITEMS} per-question graphs (ah_rag): card == CPU; F1 "
        f"{pq_agg['f1']:.2f}, EM {pq_agg['em']:.2f}, recall@10 "
        f"{pq_agg['retrieval_recall_at_10']:.3f}; per question card "
        f"{json.dumps(pcts(pq_ms['card']))}, CPU {json.dumps(pcts(pq_ms['cpu']))}; "
        f"eval_gate at gate-v4's bars {GATE_V4}: {json.dumps(gate)}")
    out["per_question"] = {"f1": pq_agg["f1"], "em": pq_agg["em"],
                           "recall_at_10": pq_agg["retrieval_recall_at_10"],
                           "card": pcts(pq_ms["card"]), "cpu": pcts(pq_ms["cpu"]),
                           "gate_v4": gate}

    # (4) a fleet of per-question graphs, stacked, and one rollout over it
    fitems = [json.loads(ln) for ln in Path(pq).read_text().splitlines()[:FLEET_ITEMS]]
    fleets, trajs = {}, {}
    for name, d in devices:
        t0 = time.perf_counter()
        fleets[name] = quiet(build_question_fleet, fitems, log=lambda *_: None, device=d)
        b, qv = fleets[name][0], torch.from_numpy(fleets[name][1]).to(d)
        traj, _ = rollout_multi(b, qv, scripted_policy, SearchWeights.create(device=d),
                                max_steps=6)
        trajs[name] = traj
        fleets[name] = (*fleets[name], time.perf_counter() - t0)
    (bc, qc, gc, mc, sc), (bp, qp, gp, mp, sp) = fleets["card"], fleets["cpu"]
    emb_err = float((bc.emb.cpu() - bp.emb).abs().max())
    for f in ("node_type", "level", "judge", "has_judge", "conf", "has_conf", "indexed",
              "valid", "parents", "children", "related", "hyperedges", "members"):
        check(torch.equal(getattr(bc, f).cpu(), getattr(bp, f)), f"fleet {f} card vs CPU")
    check(mc == mp and bc.n_nodes == bp.n_nodes and np.array_equal(gc, gp)
          and emb_err <= 1e-5 and float(np.abs(qc - qp).max()) <= 1e-5,
          f"fleet card vs CPU (emb {emb_err})")
    for f in ("actions", "dones", "mask"):
        check(torch.equal(getattr(trajs["card"], f).cpu(), getattr(trajs["cpu"], f)),
              f"fleet rollout {f} card vs CPU")
    check(float((trajs["card"].rewards.cpu() - trajs["cpu"].rewards).abs().max()) <= 1e-5,
          "fleet rollout rewards card vs CPU")
    log(f"  fleet of {FLEET_ITEMS} per-question graphs: stack {tuple(bc.emb.shape)}, "
        f"card == CPU (emb within {emb_err:.2e}), gold rows {int(gc.any(1).sum())}; "
        f"built and rolled out in {sc:.1f}s on the card, {sp:.1f}s on the CPU")
    out["fleet"] = {"graphs": FLEET_ITEMS, "n_pad": int(bc.n_pad), "card_s": sc,
                    "cpu_s": sp, "emb_err": emb_err}

    # (5) spherical k-means at scale: spherical_kmeans's steps, timed apart
    x = unit_rows(ents_1m, dev)
    k = max(1, int(round(math.sqrt(x.shape[0] / 2))))
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    cents = kmeans_init(x, k, seed=42)
    torch.cuda.synchronize(dev)
    t1 = time.perf_counter()
    cents = kmeans_em(x, cents, 25)
    torch.cuda.synchronize(dev)
    t2 = time.perf_counter()
    sizes = torch.bincount(torch.argmax(x @ cents.T, dim=1), minlength=k)
    km = {"n": int(x.shape[0]), "k": k, "init_s": t1 - t0, "em_s": t2 - t1,
          "em_step_ms": (t2 - t1) / 25 * 1e3, "nonempty": int((sizes > 0).sum()),
          "largest": int(sizes.max())}
    check(bool(torch.isfinite(cents).all()) and km["nonempty"] > 1, f"1M k-means {km}")
    del x, cents
    torch.cuda.empty_cache()
    x131 = torch.from_numpy(ents_131k)
    k131 = int(round(math.sqrt(x131.shape[0] / 2)))
    res = {}
    for name, d in devices:
        t0 = time.perf_counter()
        a, c = spherical_kmeans(x131, k131, seed=42, device=d)
        a, c = a.cpu(), c.cpu()
        res[name] = (a, c, time.perf_counter() - t0)
    differ = torch.nonzero(res["card"][0] != res["cpu"][0]).flatten()
    sims = unit_rows(ents_131k, "cpu") @ res["cpu"][1].double().T
    top2 = torch.topk(sims[differ], 2, dim=1).values if len(differ) else torch.zeros(0, 2)
    gaps = (top2[:, 0] - top2[:, 1]).tolist()
    check(all(g < 1e-5 for g in gaps), f"131k k-means: card and CPU assignments differ "
          f"beyond a near tie (top-2 gaps {gaps[:8]})")
    km.update({"n_131k": int(x131.shape[0]), "k_131k": k131,
               "card_131k_s": res["card"][2], "cpu_131k_s": res["cpu"][2],
               "near_ties_131k": len(gaps),
               "centroid_err_131k": float((res["card"][1] - res["cpu"][1]).abs().max())})
    log(f"  spherical_kmeans: {json.dumps(km)}")
    out["kmeans"] = km
    out["launches"] = launches
    return out, hgs


GYM_QUESTIONS = 64             # phase 13: XL dev questions through the gym, card and CPU
GYM_CYCLE = (0, 3, 2, 1, 4, 3)  # phase 13's scripted gym policy; a masked action falls to end
VEC_QUESTIONS = 32             # phase 13: the gym against vec_env
VEC_SEQUENCES = ((0, 3, 2, 1), (3, 0, 0, 2), (1, 2, 3, 4), (4, 3, 1, 0))   # TestVecEnvParity
PPO_BATCHES = 32               # phase 13: ppo_train batches of 4 episodes (train_ppo's envs)
TRANSFER_QUESTIONS = 32        # phase 13: rl_transfer and the knob-policy benchmark
# cli/cluster_eval at the configuration of reports/cluster_eval_10k_hier.json, and that
# report's L1 quality (the JAX package's run that wrote it)
CLUSTER_EVAL = dict(n=10000, n_topics=48, noise_frac=0.05, seed=3, n_super=8, super_frac=0.3)
CLUSTER_EVAL_REPORT = {"purity": 0.9896, "nmi": 0.9796, "n_pred_topics": 52, "n_outliers": 323}
REPORTS = SAMPLES.parent / "reports"


def printed_json(fn, argv) -> dict:
    """The JSON object a CLI's ``main(argv)`` prints last."""
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(argv)
    text = buf.getvalue()
    return json.loads(text[text.rindex("\n{") + 1 if "\n{" in text else text.index("{"):])


def gym_episode(env, query: str) -> tuple:
    """One episode of the scripted cycle (``GYM_CYCLE``, a masked action
    replaced by end): the reset's and every step's (observation, reward,
    done, mask, selection ids), and host ms of the reset and of each step."""
    def ids(info):
        return [n["node_id"] for n in info["raw_obs"].get("selection") or []]
    t0 = time.perf_counter()
    vec, info = env.reset(query)
    reset_ms = (time.perf_counter() - t0) * 1e3
    rec, step_ms, done, t = [(vec, 0.0, False, info["action_mask"], ids(info))], [], False, 0
    while not done:
        a = GYM_CYCLE[t % len(GYM_CYCLE)]
        a = a if info["action_mask"][a] else 5
        t0 = time.perf_counter()
        vec, r, done, info = env.step(a)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        rec.append((vec, r, done, info["action_mask"], ids(info)))
        t += 1
    return rec, reset_ms, step_ms


def same_episode(a, b, tol: float = 1e-5) -> bool:
    """Two ``gym_episode`` records equal, observations within ``tol``."""
    import numpy as np
    return len(a) == len(b) and all(
        float(np.abs(x[0] - y[0]).max()) <= tol and x[1:] == y[1:] for x, y in zip(a, b))


def phase_host_training(dev, hgs) -> dict:
    """The host training path on the card, over phase 12's XL pipeline graphs
    (``hgs``: the card's and the CPU's; n_pad 6,144, so every gym reset's
    anchor is one ``dense_binmax`` search). (a) ``AHRAGGymEnv`` under a
    scripted cycle over 64 dev questions, card against CPU: observations
    within 1e-5, rewards, dones, masks and selections equal (near ties
    counted), at least one ``dense_binmax`` launch per reset, ms per step.
    (b) The gym against ``vec_env.env_reset``/``env_step`` on the card's
    tensors: ``TestVecEnvParity``'s four sequences and the end action over
    32 questions (observations 2e-3, rewards 1e-5, dones equal). (c)
    ``collect_trajectories`` (gym route, seed 0) over the 64 questions,
    ``train_rl``'s frequencies and ``eval_rl_policy``'s action-prob rows, card
    against CPU, and ``train_bc`` on the card. (d) ``run_pipeline`` over the
    XL train world on the card, then ``ppo_train`` over its 150 questions
    (4 gyms, 32 batches, epochs 2, max_steps 6): episodes/s, step and update
    ms, per-batch reward, launches; and a 2-batch run resumed to 4, restoring
    the saved parameters and Adam state bit for bit. (e) That policy through
    ``eval_rl_policy`` over 64 dev questions and ``rl_transfer
    --strip-context`` (rule against PPO) over 32, on the card. (f)
    ``train_knob_policy`` on the v6 train matrix (400 steps), ``evaluate_policy``
    on the v6 dev matrix, and ``run_benchmark(system="ah_rag")`` with that
    policy over 32 dev questions, card against CPU (rows equal). (g)
    ``cluster_eval.run`` at ``CLUSTER_EVAL``, card against CPU (every metric
    equal), beside the JAX report's L1 quality."""
    import numpy as np
    import torch
    from ahrag_tpu_torch.agent import vec_env
    from ahrag_tpu_torch.agent.gym import AHRAGGymEnv
    from ahrag_tpu_torch.agent.knob_policy import (CONFIG_KNOBS, evaluate_policy,
                                                   load_knob_policy, train_knob_policy)
    from ahrag_tpu_torch.agent.ppo import PPOConfig, PPOLearner, ppo_train
    from ahrag_tpu_torch.cli import benchmark as bench
    from ahrag_tpu_torch.cli import cluster_eval, rl_transfer, train_bc, train_rl
    from ahrag_tpu_torch.cli.collect_trajectories import collect_gym
    from ahrag_tpu_torch.cli.demo import run_pipeline
    from ahrag_tpu_torch.cli.eval_rl_policy import evaluate_episodes
    from ahrag_tpu_torch.graph.search import SearchWeights
    from ahrag_tpu_torch.utils.config import load_config
    out, launches = {}, {}
    devices = (("card", dev), ("cpu", torch.device("cpu")))
    card_hg, cpu_hg = hgs["card"], hgs["cpu"]
    items = xl_questions()[:GYM_QUESTIONS]
    qs = [it["question"] for it in items]

    # (a) the gym under a scripted cycle, card against CPU
    eps, reset_ms, step_ms = {}, {}, {}
    for name, _ in devices:
        env = AHRAGGymEnv(hg=hgs[name], max_steps=6)
        reset_counts()
        runs = [gym_episode(env, q) for q in qs]
        torch.cuda.synchronize(dev)
        if name == "card":
            launches["gym"] = read_counts()
        eps[name] = [r[0] for r in runs]
        reset_ms[name] = [r[1] for r in runs]
        step_ms[name] = [ms for r in runs for ms in r[2]]
    ties = 0
    for q, a, b in zip(qs, eps["card"], eps["cpu"]):
        if not same_episode(a, b):
            check(near_tie(card_hg, cpu_hg, q),
                  f"gym: card and CPU episodes differ on {q!r}, not at a near tie")
            ties += 1
    obs_err = max(float(np.abs(x[0] - y[0]).max()) for a, b in zip(eps["card"], eps["cpu"])
                  for x, y in zip(a, b))
    check(launches["gym"]["binmax_cuda"] >= len(qs),
          f"at least one dense_binmax launch per gym reset: {launches['gym']}")
    n_steps = sum(len(e) - 1 for e in eps["card"])
    out["gym"] = {"episodes": len(qs), "steps": n_steps, "near_ties": ties, "obs_err": obs_err,
                  "launches": launches["gym"],
                  **{f"{n}_{k}": pcts(v[n]) for n in ("card", "cpu")
                     for k, v in (("reset", reset_ms), ("step", step_ms))}}
    log(f"  (a) gym, {len(qs)} XL dev episodes x {n_steps} steps: card == CPU ({ties} near "
        f"ties, obs within {obs_err:.2e}); step ms card {json.dumps(pcts(step_ms['card']))}, "
        f"CPU {json.dumps(pcts(step_ms['cpu']))}; reset ms card "
        f"{json.dumps(pcts(reset_ms['card']))}, CPU {json.dumps(pcts(reset_ms['cpu']))}; "
        f"launches {launches['gym']}")

    # (b) the gym against the device env on the card's tensors
    reset_counts()
    gt, w = card_hg.tensors(), SearchWeights.create(device=dev)
    vq = qs[:VEC_QUESTIONS]
    worst = [0.0, 0.0]
    for seq in VEC_SEQUENCES + ((5,),):
        state = vec_env.env_reset(gt, card_hg.encode_query_device(vq), w)
        gyms = [AHRAGGymEnv(hg=card_hg, max_steps=6) for _ in vq]
        obs = vec_env.observe(gt, state).cpu().numpy()
        for g, q, o in zip(gyms, vq, obs):
            worst[0] = max(worst[0], float(np.abs(g.reset(q)[0] - o).max()))
        done = [False] * len(vq)
        for a in seq:
            state, dr, dd = vec_env.env_step(gt, state, torch.full((len(vq),), a, device=dev))
            obs, dr, dd = (x.cpu().numpy() for x in (vec_env.observe(gt, state), dr, dd))
            for i, g in enumerate(gyms):
                if done[i]:
                    continue
                hvec, hr, hdone, _ = g.step(a)
                check(abs(float(dr[i]) - hr) < 1e-5 and bool(dd[i]) == hdone,
                      f"gym vs vec_env: reward or done differ at action {a} on {vq[i]!r}")
                worst[1] = max(worst[1], abs(float(dr[i]) - hr))
                if a != 5:       # the end action: rewards and dones only, as JAX's test
                    err = float(np.abs(hvec - obs[i]).max())
                    check(err <= 2e-3, f"gym vs vec_env: observations differ by {err} at "
                          f"action {a} on {vq[i]!r}")
                    worst[0] = max(worst[0], err)
                done[i] = hdone
    out["vec_env"] = {"questions": len(vq), "sequences": len(VEC_SEQUENCES) + 1,
                      "obs_err": worst[0], "reward_err": worst[1]}
    log(f"  (b) gym vs vec_env on the card, {len(vq)} questions x {len(VEC_SEQUENCES)} "
        f"sequences + end: observations within {worst[0]:.2e}, rewards within "
        f"{worst[1]:.2e}, dones equal")

    # (c) the device-independent chain, card against CPU
    trajs, policies, rows = {}, {}, {}
    for name, _ in devices:
        env = AHRAGGymEnv(hg=hgs[name], max_steps=6)
        collect_gym(env, items, f"{name}_traj.jsonl", 0)
        trajs[name] = [json.loads(ln) for ln in Path(f"{name}_traj.jsonl").read_text()
                       .splitlines()]
        quiet(train_rl.main, ["--traj", f"{name}_traj.jsonl", "--out", f"{name}_policy.json"])
        policies[name] = json.loads(Path(f"{name}_policy.json").read_text())
        probs = {int(k): float(v) for k, v in policies[name]["action_probs"].items()}
        rows[name] = evaluate_episodes(AHRAGGymEnv(hg=hgs[name], max_steps=6), items,
                                       probs=probs, seed=0)
    ties = 0
    for q, a, b, ra, rb in zip(qs, trajs["card"], trajs["cpu"], rows["card"], rows["cpu"]):
        same = len(a["steps"]) == len(b["steps"]) and all(
            (x["action"], x["reward"], x["obs_aux"]) == (y["action"], y["reward"], y["obs_aux"])
            and max(abs(u - v) for u, v in zip(x["obs_vec"], y["obs_vec"])) <= 1e-5
            for x, y in zip(a["steps"], b["steps"]))
        if not (same and ra == rb):
            check(near_tie(card_hg, cpu_hg, q), f"trajectories or eval rows differ on {q!r}, "
                  "not at a near tie")
            ties += 1
    check(ties or policies["card"] == policies["cpu"],
          "train_rl: card and CPU action frequencies differ")
    bc = printed_json(train_bc.main, ["--traj", "card_traj.jsonl", "--out", "bc_card.pt",
                                      "--device", str(dev)])
    torch.cuda.synchronize(dev)
    launches["vec_env_chain"] = read_counts()
    check(np.isfinite(bc["final_loss"]), f"train_bc on the card: {bc}")
    means = {k: float(np.mean([r["scores"][k] for r in rows["card"]]))
             for k in ("contextual_recall", "contextual_relevancy", "overall")}
    out["chain"] = {"near_ties": ties, "launches": launches["vec_env_chain"],
                    "action_probs": policies["card"]["action_probs"],
                    "bc": {k: bc[k] for k in ("n_samples", "final_loss")},
                    "eval_policy_means": means}
    log(f"  (c) collect_trajectories / train_rl / eval_rl_policy --policy: card == CPU "
        f"({ties} near ties); action probs {json.dumps(policies['card']['action_probs'])}; "
        f"train_bc on the card {json.dumps(out['chain']['bc'])}; eval means {json.dumps(means)}; "
        f"launches of (b) and (c) {launches['vec_env_chain']}")

    # (d) PPO on the host gym, on the card, over the XL train world
    t0 = time.perf_counter()
    train_hg = quiet(run_pipeline, str(SAMPLES / "synth_v4_sharedxl_corpus_train.txt"),
                     "train/artifacts", "train/graph", device=dev)
    torch.cuda.synchronize(dev)
    build_s = time.perf_counter() - t0
    train_n_pad = train_hg.tensors().n_pad
    train_qs = [json.loads(ln)["question"] for ln in
                (SAMPLES / "synth_v4_sharedxl_train.jsonl").read_text().splitlines() if ln]
    timed = {"step": [], "update": []}

    class TimedGym(AHRAGGymEnv):
        def step(self, action):
            t0 = time.perf_counter()
            res = super().step(action)
            timed["step"].append((time.perf_counter() - t0) * 1e3)
            return res

    update = PPOLearner.update

    def timed_update(self, *a, **kw):
        t0 = time.perf_counter()
        res = update(self, *a, **kw)
        torch.cuda.synchronize(dev)
        timed["update"].append((time.perf_counter() - t0) * 1e3)
        return res

    PPOLearner.update = timed_update
    logs = []
    reset_counts()
    t0 = time.perf_counter()
    learner = ppo_train(lambda: TimedGym(hg=train_hg, max_steps=6), train_qs,
                        total_episodes=PPO_BATCHES, max_steps=6, ppo_cfg=PPOConfig(epochs=2),
                        save_path="ppo/ppo_policy.pt", n_envs=4, log=logs.append, device=dev)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    PPOLearner.update = update
    launches["ppo"] = read_counts()
    episodes = sum(s.startswith("[PPO] episode=") for s in logs)
    batch_rewards = [float(s.split("mavg_ep_reward=")[1].split()[0]) for s in logs
                     if "update mavg_ep_reward=" in s]
    check(episodes == 4 * len(batch_rewards) > 0 and learner.in_dim == 84,
          f"ppo_train: {episodes} episodes in {len(batch_rewards)} batches")
    check(launches["ppo"]["binmax_cuda"] >= episodes,
          f"at least one dense_binmax launch per gym reset: {launches['ppo']}")
    check(all(np.isfinite(batch_rewards)), "finite batch rewards")
    # resume: 2 batches, then a run resumed to 4 that restores the saved state to the bit
    restored = []
    restore = PPOLearner.restore_training_state

    def checked_restore(self, path):
        progress = restore(self, path)
        saved = torch.load(path, map_location="cpu", weights_only=True)
        restored.append(all(torch.equal(v.cpu(), saved["params"][k])
                            for k, v in self.model.state_dict().items())
                        and self.opt.count == saved["opt_state"]["count"]
                        and all(torch.equal(a.cpu(), b) for a, b in
                                zip(self.opt.mu + self.opt.nu,
                                    saved["opt_state"]["mu"] + saved["opt_state"]["nu"])))
        return progress

    PPOLearner.restore_training_state = checked_restore
    resume_logs = []
    for total, resume in ((2, False), (4, True)):
        ppo_train(lambda: AHRAGGymEnv(hg=train_hg, max_steps=6), train_qs,
                  total_episodes=total, max_steps=6, ppo_cfg=PPOConfig(epochs=2),
                  save_path="ppo_resume/ppo_policy.pt", n_envs=4, resume=resume,
                  log=resume_logs.append, device=dev)
    PPOLearner.restore_training_state = restore
    check(any("resumed at batch index 8" in s for s in resume_logs) and restored == [True],
          f"resume: the resumed run restores the saved state bit for bit ({restored})")
    out["ppo"] = {"train_build_s": build_s, "train_nodes": train_hg.number_of_nodes(),
                  "train_n_pad": train_n_pad, "batches": len(batch_rewards),
                  "episodes": episodes, "wall_s": wall, "episodes_per_s": episodes / wall,
                  "step": pcts(timed["step"]), "update": pcts(timed["update"]),
                  "batch_rewards": batch_rewards, "launches": launches["ppo"],
                  "resume_batches": sum("update mavg" in s for s in resume_logs)}
    log(f"  (d) XL train world built on the card in {build_s:.2f}s "
        f"({train_hg.number_of_nodes()} nodes, n_pad {train_n_pad}); ppo_train: "
        f"{len(batch_rewards)} batches, {episodes} episodes in {wall:.2f}s "
        f"({episodes / wall:.1f} episodes/s); env step ms {json.dumps(pcts(timed['step']))}; "
        f"update ms {json.dumps(pcts(timed['update']))}; batch rewards {batch_rewards}; "
        f"launches {launches['ppo']}; resumed 2 -> 4 batches, state restored bit for bit")

    # (e) the policy on held-out questions: eval_rl_policy and rl_transfer, on the card
    reset_counts()
    t0 = time.perf_counter()
    prow = evaluate_episodes(AHRAGGymEnv(hg=card_hg, max_steps=6), items,
                             ppo=PPOLearner.load("ppo/ppo_policy.pt", device=dev), seed=0)
    eval_ms = (time.perf_counter() - t0) * 1e3 / len(items)
    pmeans = {k: float(np.mean([r["scores"][k] for r in prow]))
              for k in ("contextual_recall", "contextual_relevancy", "overall")}
    t0 = time.perf_counter()
    quiet(rl_transfer.main, ["--data", str(SAMPLES / "synth_v4_sharedxl_dev.jsonl"), "--model",
                             "ppo/ppo_policy.pt", "--limit", str(TRANSFER_QUESTIONS),
                             "--graph", "card/graph", "--strip-context", "--out",
                             "transfer.json", "--device", str(dev)])
    torch.cuda.synchronize(dev)
    xfer_ms = (time.perf_counter() - t0) * 1e3 / (2 * TRANSFER_QUESTIONS)
    launches["transfer"] = read_counts()
    xfer = json.loads(Path("transfer.json").read_text())
    keys = ("f1", "em", "retrieval_recall_at_10")
    check(xfer["n"] == TRANSFER_QUESTIONS and all(
        np.isfinite(xfer[r][k]) for r in ("rule", "ppo") for k in keys), f"rl_transfer {xfer}")
    check(launches["transfer"]["binmax_cuda"] >= len(items) + 2 * TRANSFER_QUESTIONS,
          f"(e) at least one dense_binmax launch per episode and answer: {launches['transfer']}")
    out["transfer"] = {"eval_ppo_means": pmeans, "eval_ms_per_question": eval_ms,
                       **{r: {k: xfer[r][k] for k in keys} for r in ("rule", "ppo")},
                       "delta": {k: xfer["ppo_minus_rule"][k] for k in keys},
                       "ms_per_question": xfer_ms, "launches": launches["transfer"]}
    log(f"  (e) eval_rl_policy --ppo-model over {len(items)} dev questions on the card: "
        f"{json.dumps(pmeans)}, {eval_ms:.1f} ms per question; rl_transfer --strip-context "
        f"over {TRANSFER_QUESTIONS}: rule {json.dumps(out['transfer']['rule'])}, ppo "
        f"{json.dumps(out['transfer']['ppo'])}, delta {json.dumps(out['transfer']['delta'])}, "
        f"{xfer_ms:.1f} ms per question; launches {launches['transfer']}")

    # (f) the knob policy: train on the card, evaluate, and steer run_benchmark
    t0 = time.perf_counter()
    kstats = train_knob_policy(str(REPORTS / "knob_rewards_v6_train_r5.json"),
                               "knob/knob_policy.pt", steps=400, device=dev)
    torch.cuda.synchronize(dev)
    ktrain_s = time.perf_counter() - t0
    kev = evaluate_policy(str(REPORTS / "knob_rewards_v6_dev_r5.json"), "knob/knob_policy.pt",
                          device=dev)
    cfg = load_config()
    cfg["rl"]["inference"].update(use_knob_policy=True, knob_policy_path="knob/knob_policy.pt")
    kitems = items[:TRANSFER_QUESTIONS]
    reports, kms = {}, {}
    for name, d in devices:
        kms[name] = []
        reset_counts()
        reports[name] = quiet(bench.run_benchmark, "local", system="ah_rag",
                              limit=TRANSFER_QUESTIONS,
                              data_path=str(SAMPLES / "synth_v4_sharedxl_dev.jsonl"),
                              graph_dir=f"{name}/graph", config=cfg, device=d,
                              item_ms=kms[name])
        torch.cuda.synchronize(dev)
        if name == "card":
            launches["knob"] = read_counts()
    ties = 0
    for a, b in zip(reports["card"]["items"], reports["cpu"]["items"]):
        if a != b:
            q = next(it["question"] for it in kitems if it["id"] == a["id"])
            check(near_tie(card_hg, cpu_hg, q), f"knob benchmark rows differ on {q!r}, "
                  "not at a near tie")
            ties += 1
    chosen = {}
    for name, d in devices:
        pred = load_knob_policy("knob/knob_policy.pt", device=d)
        chosen[name] = [CONFIG_KNOBS.index(pred(it["question"])) for it in kitems]
    check(chosen["card"] == chosen["cpu"], "knob choices card vs CPU")
    check(launches["knob"]["binmax_cuda"] >= TRANSFER_QUESTIONS,
          f"(f) at least one dense_binmax launch per question: {launches['knob']}")
    kagg = {k: reports["card"]["aggregate"][0][k] for k in keys}
    out["knob"] = {"train_s": ktrain_s, "train": kstats, "dev_eval": kev, "near_ties": ties,
                   "configs_chosen": {str(c): chosen["card"].count(c)
                                      for c in sorted(set(chosen["card"]))},
                   "aggregate": kagg, "card": pcts(kms["card"]), "cpu": pcts(kms["cpu"]),
                   "launches": launches["knob"]}
    log(f"  (f) knob policy trained on the card in {ktrain_s:.2f}s: {json.dumps(kstats)}; "
        f"v6 dev {json.dumps(kev)}; run_benchmark with it over {TRANSFER_QUESTIONS} dev "
        f"questions: card == CPU ({ties} near ties), configs chosen "
        f"{json.dumps(out['knob']['configs_chosen'])}, {json.dumps(kagg)}; per question card "
        f"{json.dumps(pcts(kms['card']))}, CPU {json.dumps(pcts(kms['cpu']))}")

    # (g) cluster_eval at the 10k hierarchy report's configuration, card against CPU
    ce = {name: cluster_eval.run(CLUSTER_EVAL["n"], CLUSTER_EVAL["n_topics"],
                                 CLUSTER_EVAL["noise_frac"], CLUSTER_EVAL["seed"],
                                 n_super=CLUSTER_EVAL["n_super"],
                                 super_frac=CLUSTER_EVAL["super_frac"], device=d)
          for name, d in devices}
    times = {name: {k: r.pop(k) for k in ("embed_s", "cluster_s", "l2_s")}
             for name, r in ce.items()}
    check(ce["card"] == ce["cpu"], "cluster_eval: card and CPU metrics differ")
    l1 = ce["card"]["l1"]
    quality = {"purity": l1["purity"], "nmi": l1["nmi"], "n_pred_topics": l1["n_pred_topics"],
               "n_outliers": l1["n_outliers"]}
    out["cluster_eval"] = {"times": times, "l1": quality, "jax_report_l1": CLUSTER_EVAL_REPORT,
                           "super": ce["card"].get("super"), "l2": ce["card"]["l2"]}
    log(f"  (g) cluster_eval {json.dumps(CLUSTER_EVAL)}: card == CPU; seconds "
        f"{json.dumps(times)}; L1 {json.dumps(quality)} (the JAX report: "
        f"{json.dumps(CLUSTER_EVAL_REPORT)}); super {json.dumps(ce['card'].get('super'))}")
    out["launches"] = {k: sum(v[k] for v in launches.values()) for k in launches["gym"]}
    return out


# phase 14: the learned models
ROOT = Path(__file__).resolve().parent
READER_ENSEMBLE = ";".join(str(ROOT / "checkpoints" / f) for f in ("reader.msgpack",
                                                                   "reader_b.msgpack"))
ENCODER_CKPT = str(ROOT / "checkpoints" / "encoder.msgpack")
V5_TEST = SAMPLES / "synth_v5_test.jsonl"   # 120 items: the reader, alone and arbitrated
V6_DEV = SAMPLES / "synth_v6_dev.jsonl"
READER_READS = 64              # featurized v5 reads whose logits are held card against CPU
RECALL_ITEMS = 32              # v6 dev items through the learned recall cells (of 120)
LEARNED_BUCKETS = (1, 4, 64, 128, 256)   # dense_binmax at 1/4/64, dense_binmax2 at 128/256
LEARNED_LOADS = ((1, 256), (32, 32))     # callers x requests on the learned service
MINILM_CPU_LINES = 256         # MiniLM lines encoded on the CPU too (the card encodes 4,050)
READER_TRAIN = dict(n_train=2048, n_val=256, batch=128, steps=64, lr=3e-4, seed=7)
ENCODER_TRAIN = dict(n_pairs=16384, batch=512, steps=20, lr=3e-4, temp=0.07, seed=7)
CPU_TRAIN_STEPS = 4            # training steps the CPU repeats (the card runs them all)
NOHINT = {"rescue_top_n": 0, "rescue_clause_top_n": 0, "hops": 0}   # encoder_recall_eval
RECALL_CELLS = (("learned_nohints", NOHINT), ("learned_hints", {}))
# the JAX package on the CPU (recorded in PERF.md §6): v5 TEST reader alone and
# arbitrated F1/EM over 120 items, v6 dev learned cells over the first 32
JAX_CPU = {"reader_alone": {"f1": 76.63, "em": 75.0},
           "arbitrated": {"f1": 95.83, "em": 95.83},
           "learned_nohints": {"recall_at_10": 0.9219, "mean_f1": 75.39},
           "learned_hints": {"recall_at_10": 0.9844, "mean_f1": 78.52}}


def v5_items() -> list:
    return [json.loads(ln) for ln in V5_TEST.read_text().splitlines() if ln.strip()]


def v5_sentences(item) -> list:
    """An item's raw context as the reader reads it alone
    (``tools/calibrate_reader.py``): one ``[DETAIL:p<i>]`` line per
    paragraph, cleaned into sentences."""
    from ahrag_tpu_torch.answer.extractive import _clean_sentences
    ctx = "\n".join(f"[DETAIL:p{i}] " + " ".join(para)
                    for i, para in enumerate(item["context"]["sentences"]))
    return _clean_sentences(ctx)


def reader_batch():
    """The first ``READER_READS`` v5 TEST reads, featurized and stacked."""
    from ahrag_tpu_torch.models.reader.features import featurize, stack
    return stack([featurize(it["question"], v5_sentences(it))[0]
                  for it in v5_items()[:READER_READS]])


def reader_logits(dev) -> tuple:
    """Both shipped readers' (start, end) logits of ``reader_batch()`` on
    ``dev`` as numpy, and the ms of one B = 64 forward of the first."""
    import torch
    from ahrag_tpu_torch.models.reader.model import SpanReader
    fb = reader_batch()
    out, ms = [], None
    for path in READER_ENSEMBLE.split(";"):
        model = SpanReader.from_checkpoint(path, device=dev)
        args = [torch.from_numpy(x).to(dev) for x in fb]
        with torch.no_grad():
            s, e = model(*args)
            if ms is None:
                ms = host_ms(lambda: sync(model(*args)), 5)[0]
        out.append((s.cpu().numpy(), e.cpu().numpy()))
    return out, fb.ev_mask, ms


def sync(x):
    import torch
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return x


def reader_alone(dev) -> tuple:
    """``ReaderAnswerer(ensemble, min_conf=0)`` over every v5 TEST item's raw
    context on ``dev``: ((answer, confidence) per item, ms per item)."""
    from ahrag_tpu_torch.answer.reader import ReaderAnswerer
    reader = ReaderAnswerer(READER_ENSEMBLE, min_conf=0.0, device=dev)
    out, ms = [], []
    for it in v5_items():
        sents = v5_sentences(it)
        t0 = time.perf_counter()
        out.append(reader.answer(it["question"], sents))
        ms.append((time.perf_counter() - t0) * 1e3)
    return out, ms


def reader_config() -> dict:
    from ahrag_tpu_torch.utils.config import load_config
    cfg = load_config()
    cfg.setdefault("answer", {})["reader_ckpt"] = READER_ENSEMBLE
    return cfg


def arbitrated(dev) -> tuple:
    """``run_benchmark`` (ah_rag, a graph per question) over the v5 TEST
    items with ``answer.reader_ckpt`` set to the ensemble: (report, ms per
    item)."""
    from ahrag_tpu_torch.cli import benchmark as bench
    ms = []
    rep = quiet(bench.run_benchmark, "local", system="ah_rag", limit=len(v5_items()),
                data_path=str(V5_TEST), config=reader_config(), device=dev, item_ms=ms)
    return rep, ms


def recall_rows(dev) -> tuple:
    """``tools/encoder_recall_eval.py``'s learned cells over the first
    ``RECALL_ITEMS`` v6 dev items on ``dev``: one learned-encoder graph per
    item (the tool builds the same graph once per cell), both knob cells over
    it. Returns (rows, ms per item)."""
    import tempfile
    from ahrag_tpu_torch.agent.agent import AHRAG_Agent
    from ahrag_tpu_torch.agent.environment import GraphEnvironment
    from ahrag_tpu_torch.agent.inference import InferenceEngine
    from ahrag_tpu_torch.cli.benchmark import build_question_graph
    from ahrag_tpu_torch.eval.answer_eval import squad_f1_em
    from ahrag_tpu_torch.eval.retrieval import recall_at_k
    from ahrag_tpu_torch.utils.config import load_config
    steps = int(load_config().get("inference", {}).get("steps", 4))
    items = [json.loads(ln) for ln in V6_DEV.read_text().splitlines() if ln.strip()]
    if not os.path.exists("checkpoints"):   # the encoder's default path, as from the root
        os.symlink(ROOT / "checkpoints", "checkpoints")
    rows, ms = [], []
    for it in items[:RECALL_ITEMS]:
        t0 = time.perf_counter()
        row = {"id": it.get("id"), "qtype": it.get("qtype"), "cells": {}}
        with tempfile.TemporaryDirectory() as workdir:
            hg = quiet(build_question_graph, it["context"], workdir, encoder_name="learned",
                       device=dev)
            for label, knobs in RECALL_CELLS:
                env = GraphEnvironment(hg=hg, log_level="off")
                out = InferenceEngine(env, AHRAG_Agent(env)).run_inference(
                    it["question"], steps=steps, knobs=knobs)
                rec = recall_at_k(out.get("retrieved_nodes") or [], it["gold_titles"], hg, k=10)
                row["cells"][label] = {"recall10": round(rec, 3),
                                       "f1": squad_f1_em(out.get("answer", ""),
                                                         it["answers"])["f1"]}
        rows.append(row)
        ms.append((time.perf_counter() - t0) * 1e3)
    return rows, ms


def minilm_encode(dev, n: int) -> tuple:
    """The seeded MiniLM encoder (L6, H384) over the first ``n`` corpus lines
    on ``dev``: (vectors, ms)."""
    from ahrag_tpu_torch.models.encoder.minilm import MiniLMEncoder
    enc = MiniLMEncoder(seed=0, device=dev)
    lines = corpus_lines()[:n]
    enc.encode(lines[:8])
    t0 = time.perf_counter()
    out = enc.encode(lines)
    return out, (time.perf_counter() - t0) * 1e3


def train_reader(dev, steps: int) -> tuple:
    """``READER_TRAIN``'s first ``steps`` steps at the checkpoint's width
    (d 256, 8 heads, 3 layers, d_ff 512) from the seeded initial reader:
    (losses, ms per step)."""
    import torch
    from ahrag_tpu_torch.models.reader import train as rt
    from ahrag_tpu_torch.models.reader.data import build_training_arrays
    from ahrag_tpu_torch.models.reader.model import SpanReader
    c = READER_TRAIN
    fb, (gs, ge) = build_training_arrays(c["n_train"] + c["n_val"], seed=c["seed"])
    model = SpanReader(d_model=256, n_heads=8, n_layers=3, d_ff=512, seed=c["seed"],
                       device=dev)
    opt = rt.make_optimizer(model, c["lr"], c["steps"])
    data = rt.to_device(fb, slice(0, c["n_train"]), dev)
    starts = torch.from_numpy(gs[:c["n_train"]]).to(dev)
    ends = torch.from_numpy(ge[:c["n_train"]]).to(dev)
    idx = rt.minibatch_index(c["seed"], c["n_train"], c["batch"], c["steps"])
    key = rt.jax_random.prng_key(c["seed"] * 100003)
    losses, ms = [], []
    for take in idx[:steps]:
        t0 = time.perf_counter()
        key, loss, _ = rt.train_step(model, opt, data, starts, ends, take, key)
        losses.append(float(loss))
        ms.append((time.perf_counter() - t0) * 1e3)
    return losses, ms


def train_encoder(dev, steps: int) -> tuple:
    """``ENCODER_TRAIN``'s first ``steps`` InfoNCE steps at the checkpoint's
    width (d 192, 2 layers, out 384): (losses, ms per step)."""
    from ahrag_tpu_torch.agent.optim import Adam
    from ahrag_tpu_torch.models.encoder import contrastive as ct
    c = ENCODER_TRAIN
    data = ct.pair_tensors(c["n_pairs"], c["seed"], dev)
    model = ct.SentEncoder(192, 2, 384, seed=c["seed"], device=dev)
    opt = Adam(model.parameters(), c["lr"])
    key = ct.jax_random.prng_key(c["seed"] + 1)
    losses, ms = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        key, loss, _ = ct.train_step(model, opt, data, key, c["batch"], c["temp"])
        losses.append(float(loss))
        ms.append((time.perf_counter() - t0) * 1e3)
    return losses, ms


def learned_cpu_legs(part: str) -> dict:
    """Phase 14's CPU side, in a process of its own (started with the card
    hidden) while the card runs its side: the same steps on ``device="cpu"``,
    returned for the comparison. ``part`` "benchmark" is (c); "rest" is the
    others."""
    import torch
    torch.set_num_threads(2 if part == "benchmark" else 4)
    out = {}
    with scratch_cwd():          # the answers' session files
        if part == "benchmark":
            out["arbitrated"] = arbitrated("cpu")
            return out
        out["logits"] = reader_logits("cpu")[0]
        out["alone"] = reader_alone("cpu")
        out["recall"] = recall_rows("cpu")
        out["minilm"] = minilm_encode("cpu", MINILM_CPU_LINES)
        out["reader_train"] = train_reader("cpu", CPU_TRAIN_STEPS)
        out["encoder_train"] = train_encoder("cpu", CPU_TRAIN_STEPS)
    return out


def start_cpu_legs():
    """Start both parts of ``learned_cpu_legs`` in two spawned processes that
    see no card; the caller joins them through the returned (executor,
    futures)."""
    import concurrent.futures
    import multiprocessing
    executor = concurrent.futures.ProcessPoolExecutor(
        max_workers=2, mp_context=multiprocessing.get_context("spawn"))
    old = os.environ.get("CUDA_VISIBLE_DEVICES")
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    # the workers start within these calls, with this environment
    futures = [executor.submit(learned_cpu_legs, part) for part in ("benchmark", "rest")]
    if old is None:
        del os.environ["CUDA_VISIBLE_DEVICES"]
    else:
        os.environ["CUDA_VISIBLE_DEVICES"] = old
    return executor, futures


def f1_em(rows) -> dict:
    n = len(rows)
    return {"n": n, "f1": round(sum(r["f1"] for r in rows) / n, 2),
            "em": round(sum(r["em"] >= 100 for r in rows) / n * 100, 2)}


def phase_learned(dev) -> dict:
    """Phase 14: the learned models on the card, each step held against the
    CPU (run by ``learned_cpu_legs`` in a process of its own, alongside).
    (d0) the sample corpus through ``ContrastiveEncoder`` and as a
    learned-encoder graph (D 768, n_pad 5,120), saved; (a) the two shipped
    readers' logits on 64 v5 reads; (b) the reader ensemble alone over the
    120 v5 TEST items; (c) ``run_benchmark`` with the ensemble as the answer
    stage over the same items; (d) the learned graph behind the single-stage
    ``RetrievalService`` at buckets 1/4/64/128/256 against the same service
    on the CPU, under 1 and 32 callers, then the learned v6 recall cells;
    (e) MiniLM; (f) the reader's and the contrastive encoder's trainers at
    full width; (g) the bin-max kernels at the learned graph's shape.
    Returns the launch counts of (d)'s service (the main path), the kernel
    rows at D 768 and the numbers printed."""
    import tempfile
    import numpy as np
    import torch
    from ahrag_tpu_torch.cli.serve_bench import run_load
    from ahrag_tpu_torch.eval.answer_eval import squad_f1_em
    from ahrag_tpu_torch.graph import HierarchicalGraph
    from ahrag_tpu_torch.models.encoder.contrastive import ContrastiveEncoder
    from ahrag_tpu_torch.ops.binmax import (dense_binmax, dense_binmax2, dense_binmax2_ref,
                                            dense_binmax_ref)
    from ahrag_tpu_torch.serve import RetrievalService
    out = {}
    items = v5_items()

    # (d0) the corpus through the learned encoder, and the learned graph
    lines = corpus_lines()
    enc = ContrastiveEncoder(ENCODER_CKPT, device=dev)
    enc_cpu = ContrastiveEncoder(ENCODER_CKPT, device="cpu")
    enc.encode(lines[:16])
    t0 = time.perf_counter()
    vec = enc.encode(lines)
    enc_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    vec_cpu = enc_cpu.encode(lines)
    enc_cpu_ms = (time.perf_counter() - t0) * 1e3
    enc_err = float(np.abs(vec - vec_cpu).max())
    check(vec.shape == (len(lines), 768) and enc_err <= 1e-5,
          f"learned encodings card vs CPU: {vec.shape}, {enc_err}")
    t0 = time.perf_counter()
    hg = corpus_graph(HierarchicalGraph(encoder_name="learned", device=dev))
    hg.build_vector_index(layers=(0, 1, 2))
    index_s = time.perf_counter() - t0
    graph_dir = tempfile.mkdtemp()
    hg.save(graph_dir)
    out["encode"] = {"lines": len(lines), "card_ms": enc_ms, "cpu_ms": enc_cpu_ms,
                     "max_abs_err": enc_err, "index_s": index_s}
    log(f"  (d0) {len(lines)} corpus lines through ContrastiveEncoder (D 768): card "
        f"{enc_ms:.1f} ms, CPU {enc_cpu_ms:.1f} ms, max|card-CPU| {enc_err:.2e}; learned "
        f"graph built and indexed on the card in {index_s:.1f}s")

    executor, futures = start_cpu_legs()

    # (a) logits of both readers, 64 reads
    logits, ev, logit_ms = reader_logits(dev)
    # (b) the reader alone
    alone, alone_ms = reader_alone(dev)
    # (c) arbitrated, a graph per question
    with scratch_cwd():
        reset_counts()
        arb, arb_ms = arbitrated(dev)
        arb_launches = read_counts()

    # (d) the single-stage service over the learned graph
    loaded = HierarchicalGraph.load(graph_dir, device=dev)
    svc = RetrievalService(hg=loaded, device=dev, max_batch=256)
    svc_cpu = RetrievalService(graph_dir=graph_dir, device="cpu", max_batch=256)
    gt = svc.gt
    check(not svc._hashed and gt.dim == 768 and gt.n_pad == 5120
          and gt.emb.dtype == torch.float32, f"learned graph: D {gt.dim}, n_pad {gt.n_pad}")
    qs = sample_questions(256)
    reset_counts()   # the main path: the learned service at every bucket
    card_ids, ties, bucket_ms = {}, 0, {}
    for b in LEARNED_BUCKETS:
        t0 = time.perf_counter()
        card = svc.search_many(qs[:b])
        bucket_ms[b] = (time.perf_counter() - t0) * 1e3
        cpu = svc_cpu.search_many(qs[:b])
        for q, x, y in zip(qs[:b], card, cpu):
            if result_ids([x]) != result_ids([y]):
                check(near_tie(loaded, svc_cpu.hg, q),
                      f"learned service bucket {b}: ids differ on {q!r}, not at a near tie")
                ties += 1
        card_ids[b] = result_ids(card)
    bucket_launches = read_counts()
    check(bucket_launches["binmax_cuda"] >= 3 and bucket_launches["binmax2_cuda"] >= 2,
          f"the learned service's buckets launch both bin-max kernels: {bucket_launches}")
    loads = []
    reset_counts()
    for threads, requests in LEARNED_LOADS:
        rep = run_load(svc, qs, threads=threads, requests_per_thread=requests)
        lat = rep["latency_ms"]
        check(rep["errors"] == 0, f"learned service under {threads} callers: errors")
        loads.append({"callers": threads, "requests": rep["requests"], "qps": rep["qps"],
                      "p50_ms": lat.get("p50_ms"), "p99_ms": lat.get("p99_ms")})
    load_launches = read_counts()
    svc.close()
    svc_cpu.close()
    out["service"] = {"n_pad": gt.n_pad, "dim": gt.dim, "bucket_ms": bucket_ms,
                      "near_ties": ties, "bucket_launches": bucket_launches,
                      "loads": loads, "load_launches": load_launches}
    log(f"  (d) learned service (D {gt.dim}, n_pad {gt.n_pad}) at buckets {LEARNED_BUCKETS}: "
        f"card == CPU ({ties} near ties), first-call ms {json.dumps(bucket_ms)}, launches "
        f"{bucket_launches}; under load {json.dumps(loads)}, launches {load_launches}")
    with scratch_cwd():
        reset_counts()
        recall, recall_ms = recall_rows(dev)
        recall_launches = read_counts()

    # (e) MiniLM at the default width from a seeded init
    mini, mini_ms = minilm_encode(dev, len(lines))

    # (f) both trainers at full width
    rtrain = train_reader(dev, READER_TRAIN["steps"])
    etrain = train_encoder(dev, ENCODER_TRAIN["steps"])

    # (g) the bin-max kernels at the learned graph's shape (D 768 float32)
    mask = gt.indexed & gt.valid
    n, d, tiles = gt.n_pad, gt.dim, gt.n_pad // 1024
    qdev = loaded.encode_query_device(qs)
    q1, q256 = qdev[:1].contiguous(), qdev[:256].contiguous()
    rows = {"binmax_cuda": kernel_row(
        "binmax_cuda learned B=1",
        lambda: dense_binmax(q1, gt.emb, n, mask, 1024),
        lambda: dense_binmax_ref(q1, gt.emb, n, mask, 1024),
        lambda: torch.matmul(q1, gt.emb.T).view(1, tiles, 8, 128).amax(2),
        2.0 * n * d, n * d * 4 + d * 4 + n + tiles * 128 * 4, "float32", reps=50),
        "binmax2_cuda": kernel_row(
        "binmax2_cuda learned B=256",
        lambda: dense_binmax2(q256, gt.emb, n, mask, 1024, gt.mask_trivial),
        lambda: dense_binmax2_ref(q256, gt.emb, n, mask, 1024, gt.mask_trivial),
        lambda: torch.matmul(q256, gt.emb.T).view(256, tiles, 8, 128).amax(2).amax(2),
        2.0 * 256 * n * d,
        n * d * 4 + 256 * d * 4 + (0 if gt.mask_trivial else n) + tiles * 256 * 128 * 4
        + 256 * tiles * 4, "float32", reps=50)}

    t0 = time.perf_counter()
    cpu = {k: v for f in futures for k, v in f.result(timeout=900).items()}
    executor.shutdown()
    wait_s = time.perf_counter() - t0
    shutil.rmtree(graph_dir)

    # the card against the CPU, step by step
    logit_err = max(float(np.abs(a[k][ev] - b[k][ev]).max())
                    for a, b in zip(logits, cpu["logits"]) for k in (0, 1))
    check(logit_err <= 5e-5, f"(a) reader logits card vs CPU: {logit_err}")
    cpu_alone, cpu_alone_ms = cpu["alone"]
    conf_err = max(abs(a[1] - b[1]) for a, b in zip(alone, cpu_alone))
    differ = [it["question"] for it, a, b in zip(items, alone, cpu_alone) if a[0] != b[0]]
    check(not differ and conf_err <= 1e-4,
          f"(b) reader answers card vs CPU: {differ}, confidence {conf_err}")
    scores = [dict(squad_f1_em(a or "", it["answers"])) for (a, _), it in zip(alone, items)]
    alone_agg = f1_em(scores)
    cpu_arb, cpu_arb_ms = cpu["arbitrated"]
    check(arb == cpu_arb, "(c) run_benchmark with the reader: card and CPU reports differ")
    arb_agg = arb["aggregate"][0]
    cpu_recall, cpu_recall_ms = cpu["recall"]
    check(recall == cpu_recall, "(d) learned recall rows: card and CPU differ")
    recall_agg = {label: {"recall_at_10": round(sum(r["cells"][label]["recall10"]
                                                    for r in recall) / len(recall), 4),
                          "mean_f1": round(sum(r["cells"][label]["f1"]
                                               for r in recall) / len(recall), 2)}
                  for label, _ in RECALL_CELLS}
    cpu_mini, cpu_mini_ms = cpu["minilm"]
    mini_err = float(np.abs(mini[:MINILM_CPU_LINES] - cpu_mini).max())
    check(mini.shape == (len(lines), 384) and mini_err <= 1e-5,
          f"(e) MiniLM card vs CPU: {mini.shape}, {mini_err}")
    train_err = {}
    for name, card_t in (("reader", rtrain), ("encoder", etrain)):
        cpu_t = cpu[f"{name}_train"]
        rel = max(abs(a - b) / abs(b) for a, b in zip(card_t[0], cpu_t[0]))
        check(all(math.isfinite(x) for x in card_t[0]) and rel <= 1e-4,
              f"(f) {name} training losses card vs CPU: {rel}")
        train_err[name] = rel
    out.update({
        "reader_logits": {"max_abs_err": logit_err, "b64_forward_ms": logit_ms},
        "reader_alone": {**alone_agg, "jax_cpu": JAX_CPU["reader_alone"],
                         "card": pcts(alone_ms), "cpu": pcts(cpu_alone_ms),
                         "max_conf_err": conf_err},
        "arbitrated": {"f1": arb_agg["f1"], "em": arb_agg["em"],
                       "recall_at_10": arb_agg["retrieval_recall_at_10"],
                       "jax_cpu": JAX_CPU["arbitrated"], "card": pcts(arb_ms),
                       "cpu": pcts(cpu_arb_ms), "launches": arb_launches},
        "recall": {**recall_agg, "jax_cpu": {k: JAX_CPU[k] for k, _ in RECALL_CELLS},
                   "card": pcts(recall_ms), "cpu": pcts(cpu_recall_ms),
                   "launches": recall_launches},
        "minilm": {"lines": len(lines), "card_ms": mini_ms, "cpu_lines": MINILM_CPU_LINES,
                   "cpu_ms": cpu_mini_ms, "max_abs_err": mini_err},
        "reader_train": {**READER_TRAIN, "losses": rtrain[0], "card": pcts(rtrain[1][1:]),
                         "cpu": pcts(cpu["reader_train"][1][1:]),
                         "max_rel_loss_err": train_err["reader"]},
        "encoder_train": {**ENCODER_TRAIN, "losses": etrain[0], "card": pcts(etrain[1][1:]),
                          "cpu": pcts(cpu["encoder_train"][1][1:]),
                          "max_rel_loss_err": train_err["encoder"]},
        "cpu_wait_s": wait_s, "kernels": rows})
    log(f"  (a) reader logits, {READER_READS} v5 reads x 2 checkpoints: max|card-CPU| "
        f"{logit_err:.2e} on evidence positions; one B={READER_READS} forward "
        f"{logit_ms:.2f} ms on the card")
    log(f"  (b) reader alone over {len(items)} v5 TEST items: card == CPU (max conf diff "
        f"{conf_err:.1e}); F1 {alone_agg['f1']}, EM {alone_agg['em']} (the JAX package on "
        f"the CPU: {json.dumps(JAX_CPU['reader_alone'])}); per item card "
        f"{json.dumps(pcts(alone_ms))}, CPU {json.dumps(pcts(cpu_alone_ms))}")
    log(f"  (c) run_benchmark with the reader over {len(items)} v5 TEST items: card == CPU; "
        f"F1 {arb_agg['f1']:.2f}, EM {arb_agg['em']:.2f}, recall@10 "
        f"{arb_agg['retrieval_recall_at_10']:.4f} (the JAX package on the CPU: "
        f"{json.dumps(JAX_CPU['arbitrated'])}); per question card {json.dumps(pcts(arb_ms))}, "
        f"CPU {json.dumps(pcts(cpu_arb_ms))}; launches {arb_launches}")
    log(f"  (d) learned recall cells over {RECALL_ITEMS} v6 dev items: card == CPU; "
        f"{json.dumps(recall_agg)} (the JAX package on the CPU: "
        f"{json.dumps({k: JAX_CPU[k] for k, _ in RECALL_CELLS})}); per item card "
        f"{json.dumps(pcts(recall_ms))}, CPU {json.dumps(pcts(cpu_recall_ms))}; launches "
        f"{recall_launches}")
    log(f"  (e) MiniLM L6 H384 from a seeded init: {len(lines)} lines in {mini_ms:.1f} ms on "
        f"the card; the first {MINILM_CPU_LINES} in {cpu_mini_ms:.1f} ms on the CPU, "
        f"max|card-CPU| {mini_err:.2e}")
    log(f"  (f) reader training {json.dumps(READER_TRAIN)}: losses {rtrain[0][0]:.4f} -> "
        f"{rtrain[0][-1]:.4f}, step ms card {json.dumps(pcts(rtrain[1][1:]))}, CPU "
        f"{json.dumps(pcts(cpu['reader_train'][1][1:]))} over {CPU_TRAIN_STEPS} steps, max "
        f"rel loss diff {train_err['reader']:.1e}; encoder {json.dumps(ENCODER_TRAIN)}: "
        f"losses {etrain[0][0]:.4f} -> {etrain[0][-1]:.4f}, step ms card "
        f"{json.dumps(pcts(etrain[1][1:]))}, CPU "
        f"{json.dumps(pcts(cpu['encoder_train'][1][1:]))}, max rel loss diff "
        f"{train_err['encoder']:.1e}")
    log(f"  (g) kernels at the learned graph's shape (D 768 float32, n_pad {n}): "
        f"{json.dumps(rows)}; waited {wait_s:.1f}s for the CPU side")
    out["launches"] = {k: bucket_launches[k] + load_launches[k] + arb_launches[k]
                       + recall_launches[k] for k in bucket_launches}
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 1
    from ahrag_tpu_torch import native
    from ahrag_tpu_torch.ops import _build
    from ahrag_tpu_torch.ops.binmax import (dense_binmax, dense_binmax2,
                                            dense_binmax2_ref, dense_binmax_ref)

    dev = torch.device("cuda")
    smi = smi_line()
    log(f"phase 0: {smi}; python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")

    info = _build.build()
    native_info = native.build()
    _build.load_library()
    native.load_library()
    log(f"phase 1: kernels built in {info['seconds']:.1f}s (built={info['built']}) "
        f"-> {info['path']}; native featurizer built in {native_info['seconds']:.1f}s "
        f"(built={native_info['built']}) -> {native_info['path']}")
    from ahrag_tpu_torch.ops.binmax import (binmax2_chunk, binmax2_smem_bytes, binmax_chunk,
                                            ring_smem_bytes)
    from ahrag_tpu_torch.ops.tile_topk import tile_topk_chunk, tile_topk_smem_bytes
    for name, r in kernel_report(info).items():
        log(f"  {name}: {json.dumps(r)}")
    log("  dynamic shared memory per block at D=384, tile_n=1024: " + json.dumps({
        f"binmax2 bf16 (chunk {binmax2_chunk(384)})": binmax2_smem_bytes(384, True),
        "binmax2 float32 (chunk 128)": binmax2_smem_bytes(384, False),
        f"tile_topk bf16 (chunk {tile_topk_chunk(384, 1024, True)})":
            tile_topk_smem_bytes(384, 1024, True),
        f"tile_topk float32 (chunk {tile_topk_chunk(384, 1024, False)})":
            tile_topk_smem_bytes(384, 1024, False),
        **{f"binmax {t} B={b} (chunk {binmax_chunk(b, 384, t == 'bf16')})":
           ring_smem_bytes(384, binmax_chunk(b, 384, t == "bf16"), t == "bf16")
           for t, b in (("bf16", 4), ("bf16", 64), ("float32", 64))}}))

    t = time.perf_counter()
    errs = phase_kernels_vs_plain(dev)
    phase_binmax_exact(dev)
    errs.update(phase_tile_topk_vs_plain(dev))
    log(f"phase 2: kernels vs plain done in {time.perf_counter() - t:.1f}s: {errs}")
    t = time.perf_counter()
    log("phase 3: 1M-entity rung, bf16, B=512")
    r1 = run_rung(dev, 1048576, 512, "bfloat16")
    gt, q = r1["gt"], r1["q_dev"][:512].to(torch.bfloat16).contiguous()
    n, d = gt.n_pad, gt.dim
    mask = gt.indexed & gt.valid
    trivial = gt.mask_trivial
    tiles = n // 1024
    rows = {}
    rows["binmax2_cuda"] = kernel_row(
        "binmax2_cuda",
        lambda: dense_binmax2(q, gt.emb, n, mask, 1024, trivial),
        lambda: dense_binmax2_ref(q, gt.emb, n, mask, 1024, trivial),
        lambda: torch.matmul(q, gt.emb.T).view(512, tiles, 8, 128).amax(2).amax(2),
        2.0 * 512 * n * d,
        n * d * 2 + 512 * d * 2 + (0 if trivial else n) + tiles * 512 * 128 * 4 + 512 * tiles * 4,
        "bfloat16", reps=10)
    def binmax_row(name, qb, emb, m, dtype, reps):
        """``dense_binmax`` at tile_n 1024 on a masked corpus: its row."""
        b, nn, es = qb.shape[0], emb.shape[0], emb.element_size()
        t = nn // 1024
        return kernel_row(
            name, lambda: dense_binmax(qb, emb, nn, m, 1024),
            lambda: dense_binmax_ref(qb, emb, nn, m, 1024),
            lambda: torch.matmul(qb, emb.T).view(b, t, 8, 128).amax(2),
            2.0 * b * nn * d, nn * d * es + b * d * es + nn + b * t * 128 * 4, dtype, reps)

    rows["binmax_cuda"] = binmax_row("binmax_cuda", q[:4].contiguous(), gt.emb, mask,
                                     "bfloat16", 20)
    rows["binmax_cuda"]["bfloat16 B=64"] = binmax_row(
        "binmax_cuda bf16 B=64", q[:64].contiguous(), gt.emb, mask, "bfloat16", 20)
    log(f"phase 3 done in {time.perf_counter() - t:.1f}s; kernel rows {json.dumps(rows)}")

    t = time.perf_counter()
    log("phase 4: 131072-entity rung, float32, B=2048")
    r2 = run_rung(dev, 131072, 2048, "float32")
    gt2 = r2["gt"]
    q2 = r2["q_dev"][:1024].contiguous()
    n2, t2 = gt2.n_pad, gt2.n_pad // 1024
    mask2 = gt2.indexed & gt2.valid
    f32_row = kernel_row(
        "binmax2_cuda f32",
        lambda: dense_binmax2(q2, gt2.emb, n2, mask2, 1024, gt2.mask_trivial),
        lambda: dense_binmax2_ref(q2, gt2.emb, n2, mask2, 1024, gt2.mask_trivial),
        lambda: torch.matmul(q2, gt2.emb.T).view(1024, t2, 8, 128).amax(2).amax(2),
        2.0 * 1024 * n2 * d,
        n2 * d * 4 + 1024 * d * 4 + t2 * 1024 * 128 * 4 + 1024 * t2 * 4,
        "float32", reps=10)
    rows["binmax_cuda"]["float32 B=64"] = binmax_row(
        "binmax_cuda f32 B=64", r2["q_dev"][:64].contiguous(), gt2.emb, mask2, "float32", 20)
    log(f"phase 4 done in {time.perf_counter() - t:.1f}s; binmax2 at the f32 "
        f"chunk shape (B=1024, n_pad {n2}): {json.dumps(f32_row)}; binmax at B=64: "
        f"{json.dumps(rows['binmax_cuda']['float32 B=64'])}")

    t = time.perf_counter()
    log("phase 5: flat exact top-k through dense_topk, 1M bf16 B=512 and 131k f32 B=2048")
    flat = [run_flat(dev, gt.emb, gt.n_nodes, q, "bfloat16", "1M bf16 B=512"),
            run_flat(dev, gt2.emb, gt2.n_nodes, r2["q_dev"].contiguous(), "float32",
                     "131k f32 B=2048")]
    rows["tile_topk_cuda"] = flat[0]["kernel"]
    rows["tile_topk_cuda"]["float32"] = flat[1]["kernel"]
    rows["binmax2_cuda"]["float32"] = f32_row
    log(f"phase 5 done in {time.perf_counter() - t:.1f}s")
    ents_131k = r2["arrs"].emb[:r2["arrs"].n_entities]
    del r2, gt2, q2, mask2

    t = time.perf_counter()
    log("phase 6: serve text queries against the 1M-node graph")
    import numpy as np
    from ahrag_tpu_torch.bench_data import bench_tensors
    from ahrag_tpu_torch.graph.search import SearchWeights
    from ahrag_tpu_torch.models.encoder.hashed import HashedNGramEncoder
    from ahrag_tpu_torch.serve import encode_and_search, pack_queries
    texts = ["who directed the 1994 biographical film ed wood",
             "american superhero film directed by scott derrickson",
             "hierarchical retrieval over topic summaries",
             "community of film directors and their works"]
    enc = HashedNGramEncoder(dim=d, device=dev)
    idf = torch.from_numpy(np.random.default_rng(5).uniform(
        0.5, 2.0, enc.buckets).astype(np.float32))
    n_q, n_rows, packed = pack_queries(texts, enc)
    reset_counts()
    t_s = time.perf_counter()
    out_gpu = encode_and_search(packed, enc._proj, idf.to(dev), gt, r1["w"],
                                n_rows=n_rows, top_k=5, member_top_m=5).cpu()
    serve_ms = (time.perf_counter() - t_s) * 1e3
    serve_counts = read_counts()
    gt_cpu = bench_tensors(r1["arrs"], "bfloat16", device="cpu")
    out_cpu = encode_and_search(packed, enc._proj.cpu(), idf, gt_cpu,
                                SearchWeights.create(device="cpu"),
                                n_rows=n_rows, top_k=5, member_top_m=5)
    ids_gpu = out_gpu[:n_q, :, 0].long().tolist()
    ids_cpu = out_cpu[:n_q, :, 0].long().tolist()
    score_err = (out_gpu[:n_q] - out_cpu[:n_q]).abs().max().item()
    log(f"  bucket {n_rows}, packed {packed.shape}, first call {serve_ms:.1f} ms, "
        f"launches {serve_counts}, ids cuda {ids_gpu}, max|cuda-cpu| {score_err:.3e}")
    check(ids_gpu == ids_cpu, f"serve ids cuda {ids_gpu} != cpu {ids_cpu}")
    check(bool((out_gpu[:n_q, :, 3] == out_cpu[:n_q, :, 3]).all()), "serve valid flags")
    check(score_err <= 1e-5, f"serve scores differ by {score_err}")
    check(serve_counts["binmax_cuda"] > 0, "binmax kernel launched by the serve bucket")
    served = phase_serve_buckets(dev, enc, idf, r1, gt_cpu)
    log(f"phase 6 done in {time.perf_counter() - t:.1f}s")

    t = time.perf_counter()
    log("phase 7: encode_device over the sample corpus, card and CPU")
    encoded = phase_encode(dev, d)
    log(f"phase 7 done in {time.perf_counter() - t:.1f}s")

    t = time.perf_counter()
    log("phase 8: a host graph of the sample corpus, indexed, saved, loaded and served")
    hosted, host_hg, host_hg_cpu = phase_host_graph(dev)
    check(hosted["launches"]["binmax_cuda"] > 0 and hosted["launches"]["binmax2_cuda"] > 0,
          f"both bin-max kernels on the service path: {hosted['launches']}")
    log(f"phase 8 done in {time.perf_counter() - t:.1f}s")

    t = time.perf_counter()
    log("phase 9: the service at 1M nodes, bf16, max_batch 512")
    loaded = phase_service_1m(dev, gt, gt_cpu, r1["arrs"])
    check(loaded["launches"]["binmax_cuda"] > 0 and loaded["launches"]["binmax2_cuda"] > 0,
          f"both bin-max kernels under load: {loaded['launches']}")
    log(f"phase 9 done in {time.perf_counter() - t:.1f}s")

    t = time.perf_counter()
    log("phase 10: the agent at 1M nodes, bf16: rollouts at B=512 and 16, training, "
        "many graphs")
    agent = phase_agent(dev, r1, gt_cpu, smi)
    check(agent["launches"]["binmax_cuda"] > 0 and agent["launches"]["binmax2_cuda"] > 0,
          f"both bin-max kernels on the agent's path: {agent['launches']}")
    log(f"phase 10 done in {time.perf_counter() - t:.1f}s")

    t = time.perf_counter()
    log("phase 11: answers on the card: the XL dev world and phase 8's graph")
    answered = phase_answers(dev, host_hg, host_hg_cpu)
    check(answered["launches"]["binmax_cuda"] > 0,
          f"dense_binmax on the answer path: {answered['launches']}")
    answered["wall_s"] = time.perf_counter() - t
    log(f"phase 11 done in {answered['wall_s']:.1f}s")

    t = time.perf_counter()
    log(f"phase 12: build, answer and score on the card: the XL pipeline, {XL_BENCH_QUESTIONS} "
        "questions, "
        "per-question graphs, a fleet, k-means at 1M")
    with scratch_cwd():          # phase 12's graphs stay here for phase 13
        built, xl_hgs = phase_build(dev, r1["arrs"].emb[:r1["arrs"].n_entities], ents_131k)
        built["wall_s"] = time.perf_counter() - t
        log(f"phase 12 done in {built['wall_s']:.1f}s")

        t = time.perf_counter()
        log("phase 13: the host training path on the card: the gym, ppo_train, the RL CLIs, "
            "the knob policy and cluster_eval")
        trained = phase_host_training(dev, xl_hgs)
        trained["wall_s"] = time.perf_counter() - t
        log(f"phase 13 done in {trained['wall_s']:.1f}s")
    del xl_hgs

    t = time.perf_counter()
    log("phase 14: the learned models on the card: the span reader, the learned and MiniLM "
        "encoders, the single-stage service and both trainers")
    learned = phase_learned(dev)
    learned["wall_s"] = time.perf_counter() - t
    rows["binmax_cuda"]["learned float32 D=768 B=1"] = learned["kernels"]["binmax_cuda"]
    rows["binmax2_cuda"]["learned float32 D=768 B=256"] = learned["kernels"]["binmax2_cuda"]
    log(f"phase 14 done in {learned['wall_s']:.1f}s")

    path_counts = {k: r1["rung"]["launches"][k] + serve_counts[k]
                   + served["bucket64_launches"][k] + sum(f["launches"][k] for f in flat)
                   + hosted["launches"][k] + hosted["answer_launches"][k]
                   + loaded["launches"][k] + agent["launches"][k] + answered["launches"][k]
                   + built["launches"][k] + trained["launches"][k]
                   + learned["launches"][k] for k in rows}
    kernels = []
    for name, source, replaces in (
            ("binmax2_cuda", "ahrag_tpu_torch/ops/csrc/binmax.cu", "ahrag_tpu/ops/topk.py:651"),
            ("binmax_cuda", "ahrag_tpu_torch/ops/csrc/binmax.cu", "ahrag_tpu/ops/topk.py:554"),
            ("tile_topk_cuda", "ahrag_tpu_torch/ops/csrc/tile_topk.cu",
             "ahrag_tpu/ops/topk.py:459")):
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": path_counts[name],
                        **rows[name]})
    from ahrag_tpu_torch.ops.topk import binmax_eps
    eps = {"bfloat16": binmax_eps("cuda", d, 1024, True),
           "float32": binmax_eps("cuda", d, 1024, False)}
    log(f"binmax_eps at d={d}, tile_n=1024 (through dense_binmax and dense_binmax2): "
        f"{json.dumps(eps)}")
    for k in kernels:
        k["max_abs_err"] = max(k["max_abs_err"], errs[k["name"]])
        k["eps"] = eps
    kernels[2]["max_abs_err"] = max(kernels[2]["max_abs_err"],
                                    *(f["max_abs_err_vs_ref"] for f in flat))
    # what the designs ask of L2 or HBM: the corpus once per query chunk
    # (binmax2 chunks of 128, tile_topk of 32); how much of it HBM serves is
    # not measured
    log("corpus bytes requested per launch (design count, not a DRAM reading): " + json.dumps({
        "binmax 1M bf16 B=4 and B=64": n * d * 2,
        "binmax 131k f32 B=64": n2 * d * 4,
        "binmax2 1M bf16 B=512": n * d * 2 * (512 // 128),
        "binmax2 131k f32 B=1024": n2 * d * 4 * (1024 // 128),
        "tile_topk 1M bf16 B=512": n * d * 2 * (512 // 32),
        "tile_topk 131k f32 B=2048": n2 * d * 4 * (2048 // 32)}))
    log(f"summary {json.dumps({'flat': [{k: v for k, v in f.items() if k != 'kernel'} for f in flat], 'tile_topk_131k_f32': flat[1]['kernel'], 'featurize': served['featurize'], 'encode': encoded, 'host_graph': hosted, 'service_1m': loaded, 'agent': agent, 'answers': answered, 'build': built, 'host_training': trained, 'learned': learned})}")
    log(f"total wall {time.perf_counter() - _T0:.1f}s")
    print(smi_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
