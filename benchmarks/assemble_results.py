"""Assemble RESULTS.md from docs/results/*.json (quality_parity +
detector_quality runs).

The table layout mirrors the reference protocol outputs:
- anytime degradation sweep (nolbo.py:199-259, test_modelnet_3D.py:117-143):
  P/R uncorrected vs prior-corrected per missing rate, plus category accuracy
  where the variant classifies;
- PR curve summary (modelnetAE3.ipynb): best-F1 threshold row + the
  acceptance-probability tail's highest-precision row;
- blocked-vs-classic layout A/B at convergence;
- detection metrics (P/R/mAP@0.5/orientation MAE) for the detector family.

Usage: python benchmarks/assemble_results.py [--results docs/results] [--out RESULTS.md]
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np


def f(x, nd=3):
    return f"{x:.{nd}f}"


def sweep_table(res: dict) -> list:
    has_inst = "acc_inst" in res["eval_full"]
    header = "| missing rate | P | R | P corrected | R corrected | acc | acc corrected |"
    rule = "|---|---|---|---|---|---|---|"
    if has_inst:
        header += " acc_inst |"
        rule += "---|"
    lines = [header, rule]
    full = res["eval_full"]
    row = "| 0.0 (full) | {} | {} | — | — | {} | — |".format(
        f(full["precision"]), f(full["recall"]),
        f(full["acc_category"]) if "acc_category" in full else "—",
    )
    if has_inst:
        row += f" {f(full['acc_inst'])} |"
    lines.append(row)
    for rate in ("0.3", "0.5", "0.7", "0.9"):
        m = res["sweep"][rate]
        row = "| {} | {} | {} | {} | {} | {} | {} |".format(
            rate, f(m["precision"]), f(m["recall"]),
            f(m.get("precision_corrected", float("nan"))),
            f(m.get("recall_corrected", float("nan"))),
            f(m["acc_category"]) if "acc_category" in m else "—",
            f(m["acc_category_corrected"]) if "acc_category_corrected" in m else "—",
        )
        if has_inst:
            row += f" {f(m['acc_inst'])} |" if "acc_inst" in m else " — |"
        lines.append(row)
    return lines


def pr_summary(curve: dict) -> str:
    p = np.asarray(curve["precision"])
    r = np.asarray(curve["recall"])
    thr = np.asarray(curve["threshold"])
    acc = np.asarray(curve["accept_prob"])
    plain = np.isnan(acc)
    f1 = 2 * p * r / np.maximum(p + r, 1e-10)
    i = int(np.argmax(np.where(plain, f1, -1)))
    out = f"best F1 {f(f1[i])} at threshold {thr[i]:.2f} (P {f(p[i])}, R {f(r[i])})"
    if (~plain).any():
        j = int(np.argmax(np.where(~plain, p, -1)))
        out += f"; acceptance tail up to P {f(p[j])} at accept_prob {acc[j]:.0e} (R {f(r[j])})"
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--results", default="docs/results")
    ap.add_argument("--out", default="RESULTS.md")
    args = ap.parse_args(argv)

    runs = {}
    for path in sorted(glob.glob(os.path.join(args.results, "*.json"))):
        name = os.path.splitext(os.path.basename(path))[0]
        with open(path) as fh:
            data = json.load(fh)
        # only quality runs join the sweep sections; other artifacts
        # (scaling_cpu) are linked below
        if "sweep" in data or name.startswith("detector"):
            runs[name] = data

    lines = [
        "# RESULTS — quality parity runs",
        "",
        "All runs: one accelerator, bf16 compute, the class-informative",
        "synthetic ModelNet40 stand-in (data/modelnet.py::SyntheticVoxelLoader —",
        "no real shards ship in this image; 8 shape families x per-class",
        "extents x 4 yaw rotations, the dataset's 4rot analogue). Protocols",
        "follow the reference exactly: anytime degradation sweep",
        "(/root/reference/src/module/nolbo.py:199-259,",
        "/root/reference/test_modelnet_3D.py:117-143), PR curve with the",
        "acceptance-probability tail (/root/reference/modelnetAE3.ipynb cell 2),",
        "category accuracy by nearest prior mean (nolbo.py:214-227).",
        "Raw JSONs (auditable, incl. full PR curves): docs/results/.",
        "",
    ]

    order = [k for k in (
        "modelnet_nolbo", "modelnet_nolbo_classic", "modelnet_vae", "modelnet_ae",
    ) if k in runs] + [
        k for k in runs if k not in (
            "modelnet_nolbo", "modelnet_nolbo_classic", "modelnet_vae",
            "modelnet_ae", "detector",
        )
    ]

    for name in order:
        res = runs[name]
        if name.startswith("detector"):
            continue
        tag = res.get("layout", res.get("family", ""))
        lines.append(f"## {res['config']} ({tag})" if tag else f"## {res['config']}")
        lines.append("")
        if res.get("family") == "image->shape":
            lines.append(
                "Image->voxel (SyntheticImageObjectLoader silhouette renders, "
                f"multi-scale {res.get('multi_scale')}, inst_spread "
                f"{res.get('inst_spread', 0.15)}; correction mode "
                f"'{res.get('correction_mode', 'resample')}')."
            )
            lines.append("")
        lines.append(
            f"{res['steps']} steps, batch {res['batch_size']}, {res['dtype']}; "
            f"final train metrics: "
            + ", ".join(
                f"{k}={v:.4g}" for k, v in sorted(res["final_train"].items())
            )
        )
        lines.append("")
        if res.get("note"):
            lines.append(res["note"])
            lines.append("")
        lines.extend(sweep_table(res))
        lines.append("")
        lines.append(
            "PR @ missing 0.3 (uncorrected): " + pr_summary(res["pr_curve_missing03"])
        )
        lines.append(
            "PR @ missing 0.3 (corrected): "
            + pr_summary(res["pr_curve_missing03_corrected"])
        )
        lines.append("")

    if "modelnet_nolbo" in runs and "modelnet_nolbo_classic" in runs:
        rb, rc = runs["modelnet_nolbo"], runs["modelnet_nolbo_classic"]
        b, c = rb["eval_full"], rc["eval_full"]
        lines.append("## Blocked vs classic layout A/B")
        lines.append("")
        lines.append("Full-observation eval at each run's final step:")
        lines.append("")
        lines.append("| layout | steps | P | R | acc |")
        lines.append("|---|---|---|---|---|")
        variants = [("blocked (default)", rb), ("classic (reference)", rc)] + [
            (lbl, runs[k])
            for lbl, k in (
                ("enc_blocked (blocked head, classic dec)", "modelnet_nolbo_encblocked"),
                ("dec_blocked (classic head, blocked tail)", "modelnet_nolbo_decblocked"),
                ("ps_final (blocked head, pixel-shuffle final only)", "modelnet_nolbo_psfinal"),
                ("equiv (acc config: blocked head, classic dec via exact phase lowering)", "modelnet_nolbo_equiv"),
                ("blocked + initfix (1/8 tail init variance, r5)", "modelnet_nolbo_initfix"),
                ("blocked + phasenorm (classic-stat tail GroupNorm, r5)", "modelnet_nolbo_phasenorm"),
                ("blocked + initfix + phasenorm (r5)", "modelnet_nolbo_dynfix"),
            )
            if k in runs
        ]
        for label, res in variants:
            m = res["eval_full"]
            lines.append(
                f"| {label} | {res['steps']} | {f(m['precision'])} | "
                f"{f(m['recall'])} | {f(m.get('acc_category', float('nan')))} |"
            )
        lines.append("")
        if len(variants) > 2:
            lines.append(
                "r4 isolation: reconstruction P/R is at parity in every "
                "layout; the category-accuracy gap is carried ENTIRELY by "
                "the blocked/pixel-shuffle decoder TAIL (enc_blocked ≥ "
                "classic; ps_final shows the final-stage reformulation is "
                "most of it). The blocked encoder head is free — "
                "`configs.modelnet_nolbo_acc` combines it with the classic "
                "decoder for classification-critical workloads, and since "
                "r4's exact phase-equiv lowering (KERNELS.md §5) it runs "
                "the classic parameterization through phase convs: same "
                "kernel tensors, init, and Adam "
                "trajectory as enc_blocked, different lowering — the "
                "'equiv' row is the empirical confirmation."
            )
            lines.append("")
        # matched-step comparison from the training JSONLs (fair A/B when
        # the runs trained different step counts)
        curves = {}
        for key, res in (("blocked", rb), ("classic", rc)):
            path = os.path.join(args.results, f"train_{key}.jsonl")
            if os.path.exists(path):
                with open(path) as fh:
                    curves[key] = [json.loads(ln) for ln in fh if ln.strip()]
        if len(curves) == 2:
            common = min(
                curves["blocked"][-1]["step"], curves["classic"][-1]["step"]
            )
            rows = {
                k: [r for r in v if r["step"] <= common][-5:]
                for k, v in curves.items()
            }
            lines.append(
                f"Training metrics near matched step {common} (mean of the "
                "last 5 logged rows; docs/results/train_*.jsonl):"
            )
            lines.append("")
            lines.append("| layout | P | R | shape loss |")
            lines.append("|---|---|---|---|")
            for k in ("blocked", "classic"):
                rs = rows[k]
                mean = lambda key: sum(r[key] for r in rs) / len(rs)
                lines.append(
                    f"| {k} | {f(mean('precision'))} | {f(mean('recall'))} | "
                    f"{mean('loss_shape'):.0f} |"
                )
            lines.append("")

    det_runs = {k: v for k, v in runs.items() if k.startswith("detector")}
    if det_runs:
        lines.append("## Detector (synthetic multi-object curriculum)")
        lines.append("")
        lines.append("Held-out detection vs curriculum size (the r2 diagnosis"
                      " was curriculum-bound; photometric = imgAug-style"
                      " train-time jitter):")
        lines.append("")
        lines.append("| run | scenes | steps | photometric | P | R | mAP@0.5 | ori MAE (rad) |")
        lines.append("|---|---|---|---|---|---|---|---|")
        for k in sorted(det_runs, key=lambda k: det_runs[k].get("train_samples", 1024)):
            r = det_runs[k]
            d = r["detection"]
            lines.append(
                f"| {k} | {r.get('train_samples', 1024)} | {r['steps']} | "
                f"{'yes' if r.get('photometric') else 'no'} | "
                f"{f(d['det_precision'])} | {f(d['det_recall'])} | "
                f"{f(d['map50'])} | {f(d['ori_mae_rad'])} |"
            )
        lines.append("")
        for k, r in sorted(det_runs.items()):
            if r.get("note"):
                lines.append(f"`{k}`: {r['note']}")
                lines.append("")
            if r.get("artifact"):
                lines.append(f"`{k}` scene overlay artifact: {r['artifact']}")
                lines.append("")

    # ---- multi-view anytime fusion (the paper's titular capability)
    fusion_path = os.path.join(args.results, "streaming_fusion.json")
    fusion_checks = []
    if os.path.exists(fusion_path):
        with open(fusion_path) as fh:
            fu = json.load(fh)
        c = fu["curves_vs_N"]
        V = fu["views"]
        lines.append("## Multi-view anytime fusion (streaming_fusion.json)")
        lines.append("")
        lm = fu.get("latent_mask", 0.0)
        mode = (
            f"each view a PARTIAL observation revealing {lm:.0%} of its "
            "posterior dims (the reference's own observation model, "
            "nolbo.py:199-208, applied per real view); fused by the MASKED "
            "information filter, unobserved dims at the reference fill"
            if lm
            else "per-view FULL posteriors fused precision-weighted in "
            "information form (anytime/engine.py::fuse_observation)"
        )
        lines.append(
            f"Held-out objects ({fu['objects']}, structural curriculum), "
            f"N = 1..{V} distinct rendered views per object; {mode}; the "
            "fused mean decoded. 'avg' = uniform mean ablation (ignores "
            "the encoder's per-dim variance). The last column is the "
            "reference's SINGLE-shot masked protocol (nolbo.py:199-259) at "
            "missing_prob = 1-1/N on one view with gated correction — what "
            "the reference can do with one degraded observation, vs what "
            "the filter does with N real ones. 'Best single view' is the "
            "ORACLE per-object max over the N individual observations."
        )
        if lm:
            lines.append("")
            lines.append(
                f"Each view here carries missing_prob = {1-lm:.0%} of its "
                "latent dims; the reference's one-shot protocol at that "
                "rate is the N-independent floor (see the structural-64k "
                "sweep's 0.7 row), while the filter recovers the "
                "full-information ceilings as coverage "
                f"(1-(1-{lm:.1f})^N) grows."
            )
        lines.append("")
        lines.append("| N | fused IoU | avg IoU | fused P | fused R | acc_cat | acc_inst | masked-protocol R (corrected) |")
        lines.append("|---|---|---|---|---|---|---|---|")
        for i in range(V):
            mk = fu["masked_protocol_matched_info"].get(str(i + 1), {})
            mrec = mk.get("recall_corrected", mk.get("recall"))
            lines.append(
                f"| {i+1} | {f(c['fused_iou'][i])} | {f(c['avg_iou'][i])} | "
                f"{f(c['fused_precision'][i])} | {f(c['fused_recall'][i])} | "
                f"{f(c['fused_acc_category'][i])} | {f(c['fused_acc_inst'][i])} | "
                f"{f(mrec) if mrec is not None else '—'} |"
            )
        lines.append("")
        lines.append(
            f"Best SINGLE view IoU (oracle view selection): "
            f"{f(fu['best_single_iou'])}; first view: {f(fu['first_single_iou'])}."
        )
        lines.append("")
        if fu.get("occlude"):
            lines.append(
                "Views are PARTIAL observations (random half-plane occlusion "
                "per view) — the anytime deployment setting. The full-"
                "silhouette control is below."
            )
            lines.append("")
        fv_path = os.path.join(args.results, "streaming_fusion_fullviews.json")
        if os.path.exists(fv_path):
            with open(fv_path) as fh:
                fv = json.load(fh)
            cf = fv["curves_vs_N"]
            Vf = fv["views"]
            lines.append(
                f"Full-silhouette control (streaming_fusion_fullviews.json): "
                f"fused IoU {f(cf['fused_iou'][0])} -> "
                f"{f(cf['fused_iou'][Vf-1])} over N=1..{Vf} "
                f"(pofe {f(cf['pofe_iou'][Vf-1])}), oracle single "
                f"{f(fv['best_single_iou'])} — complete views are near-"
                "redundant for this model class (the NOLBO KL calibrates "
                "posterior variance to the class prior, not observation "
                "certainty), so fusion saturates at the single-view ceiling; "
                "the measured finding that motivated OccupancyBelief."
            )
            lines.append("")
        iou = c["fused_iou"]
        mono = all(b >= a - 0.003 for a, b in zip(iou, iou[1:]))
        fusion_checks.append(
            f"- `streaming_fusion`: fused IoU monotone in N: {'yes' if mono else 'NO'}"
        )
        fusion_checks.append(
            f"  fused@{V} ({f(iou[-1])}) vs best single view "
            f"({f(fu['best_single_iou'])}): "
            f"{'beats' if iou[-1] > fu['best_single_iou'] else 'does NOT beat'}"
        )
        acc = c["fused_acc_category"]
        fusion_checks.append(
            f"  fused acc_category {f(acc[0])} -> {f(acc[-1])} over N "
            f"({'monotone-ish' if acc[-1] >= acc[0] else 'DEGRADES'})"
        )

    # ---- auto-checked summary of the reference's claimed behaviors
    checks = list(fusion_checks)
    for name in order:
        res = runs[name]
        if "sweep" not in res:
            continue
        sweep = res["sweep"]
        rates = sorted(sweep, key=float)
        rec = [sweep[r]["recall"] for r in rates]
        mono = all(a >= b - 0.005 for a, b in zip(rec, rec[1:]))
        checks.append(
            f"- `{name}`: degradation monotone in missing rate: "
            f"{'yes' if mono else 'NO'}"
        )
        if "acc_inst" in sweep[rates[0]]:
            inst = [sweep[r]["acc_inst"] for r in rates]
            checks.append(
                f"  instance accuracy {f(min(inst))}-{f(max(inst))} vs 0.100 "
                f"chance: {'above' if min(inst) > 0.1 else 'NOT above'}"
            )
        if "acc_category_corrected" in sweep[rates[0]]:
            acc_win = all(
                sweep[r]["acc_category_corrected"] >= sweep[r]["acc_category"] - 0.005
                for r in rates
            )
            n_rec = sum(
                sweep[r]["recall_corrected"] >= sweep[r]["recall"] for r in rates
            )
            checks.append(
                f"  correction: acc corrected >= uncorrected at "
                f"{'every rate' if acc_win else 'NOT every rate'}; recall "
                f"corrected wins at {n_rec}/{len(rates)} rates"
            )
    for extra, label in (
        ("scaling_cpu", "CPU-mesh scaling semantics validation"),
    ):
        path = os.path.join(args.results, extra + ".json")
        if os.path.exists(path):
            lines.append(f"Additional artifact: `docs/results/{extra}.json` — {label}.")
            lines.append("")

    lines.append("## Summary (auto-checked)")
    lines.append("")
    lines.extend(checks)
    lines.append("")

    with open(args.out, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    print("wrote", args.out, f"({len(order)} quality runs)")


if __name__ == "__main__":
    main()
