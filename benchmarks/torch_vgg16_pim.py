"""VGG-16 configuration D on the simulated PIM against its plain reference,
on the card.

Draws the weights (``vgg.init_params``) and a batch of N(0, 1) images from
``--seed``, runs ``vgg.pim_forward`` on ``--basis`` and
``vgg_reference.forward`` on the card, and counts the differing elements
(bit for bit, NaN as NaN) of every conv layer's output and of the logits.
``--groups K`` below 5 runs the first K conv groups alone and compares their
pooled, flattened output in place of the logits.  Then it splits the time of
one conv call in each group's first layer (``--split-channels`` input
channels of it) between ``conv.gather`` and ``pim.call``: the profiler's
device time by the port span that launched each event, and the spans' host
time.  Prints one JSON object; exits 1 when an element differs.

    PYTHONPATH=src python -m benchmarks.torch_vgg16_pim [--basis dram] [--groups 1]

``--device cpu`` runs the kernels' plain versions (hours at full size).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import spans
from repro_torch.models import vgg
from repro_torch.models import vgg_reference as ref
from repro_torch.pim.conv import conv3x3
from repro_torch.pim.frontend import resolve_device


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"not read ({exc})"


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def split(params: dict, batch: int, image: int, basis: str, device: torch.device,
          channels: int) -> list[dict]:
    """Device and host ms a call of the gather (``conv.gather``) and of the
    PIM call (``pim.call``), in the first layer of each group, over its
    first ``channels`` input channels.  A device event goes to the port
    span whose runtime call launched it, as the benchmark's traced window
    splits a call (``pimbench.attribution``); ``other`` is the layer's own
    padding and bias broadcast."""
    from pimbench import attribution, tracing

    layers = vgg.conv_layers(vgg.CONFIG_D, image)
    rows, first = [], 0
    for g, group in enumerate(params["convs"]):
        cin, cout, side = layers[first]
        first += len(group)
        cin = min(channels, cin)
        w, b = group[0]
        w = w[:, :cin].contiguous()
        x = torch.randn((batch, cin, side, side), device=device)
        conv3x3(x, w, b, basis=basis)  # warm
        sync(device)
        activity = ProfilerActivity.CUDA if device.type == "cuda" else ProfilerActivity.CPU
        start = time.time_ns()
        with spans.recording() as rec, profile(activities=[activity]) as prof:
            conv3x3(x, w, b, basis=basis)
            sync(device)
        end = time.time_ns()
        calls = [tracing.CallSpan(batch * cout * side * side, start, end, end)]
        attr = attribution.attribute(tracing.read_profile(prof, calls, rec), rec)
        ns = {"gather": 0, "pim.call": 0, "other": 0}
        for name, t in attr.device_ns.items():
            ns["gather" if name == "conv.gather" else "other"
               if name in ("conv.layer", attribution.UNATTRIBUTED) else "pim.call"] += t
        host = {name: sum((s.end_ns - s.start_ns) for s in rec if s.name == name) / 1e6
                for name in ("conv.gather", "pim.call")}
        rows.append({"group": g + 1, "rows": batch * cout * side * side, "calls": cin,
                     "device_ms_a_call": {k: v / 1e6 / cin for k, v in ns.items()},
                     "host_ms_a_call": {k: v / cin for k, v in host.items()}})
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--basis", default="memristive", choices=("memristive", "dram"))
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--image", type=int, default=224)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--groups", type=int, default=len(vgg.CONFIG_D.groups))
    p.add_argument("--split-channels", type=int, default=8)
    p.add_argument("--json", default=None, help="also write the result here")
    p.add_argument("--device", default=None)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(args.seed)
    params = vgg.init_params(vgg.CONFIG_D, args.image, device=device, generator=gen)
    x = torch.randn((args.batch, 3, args.image, args.image), generator=gen).to(device)
    if args.groups < len(vgg.CONFIG_D.groups):
        params = {"convs": params["convs"][:args.groups], "fc": []}
    sync(device)
    t1 = time.perf_counter()
    got_layers: list = []
    logits = vgg.pim_forward(params, x, args.basis, keep=got_layers)
    sync(device)
    t2 = time.perf_counter()
    want_layers: list = []
    want = ref.forward(params, x, keep=want_layers)
    sync(device)
    t3 = time.perf_counter()
    layers = [ref.differing(a, b) for a, b in zip(got_layers, want_layers)]
    result = {
        "card": card(), "basis": args.basis, "batch": args.batch, "image": args.image,
        "seed": args.seed, "groups": args.groups,
        "differing_by_layer": layers, "layer_elements": [t.numel() for t in want_layers],
        "differing_logits": ref.differing(logits, want), "logits_elements": want.numel(),
        "nan_logits": int(logits.isnan().sum()),
        "setup_s": t1 - t0, "pim_forward_s": t2 - t1, "reference_s": t3 - t2,
        "conv_waves": spans.counters("conv.").get("conv.waves", 0),
        "peak_gib": (torch.cuda.max_memory_allocated(device) / 2**30
                     if device.type == "cuda" else None),
    }
    del got_layers, want_layers, logits, want
    result["split"] = split(params, args.batch, args.image, args.basis, device,
                            args.split_channels)
    text = json.dumps(result)
    print(text, flush=True)
    if args.json:
        with open(args.json, "w") as f:
            f.write(text + "\n")
    return int(any(layers) or result["differing_logits"] > 0 or len(layers) == 0)


if __name__ == "__main__":
    sys.exit(main())
