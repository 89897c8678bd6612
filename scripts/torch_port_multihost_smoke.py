"""One rank of a data-parallel run of the PyTorch port (the counterpart of
``scripts/multihost_smoke.py``), and the probe that compares such a run
with another.

Every rank runs this same script with its own ``--process_id``; the ranks
join one ``torch.distributed`` process group (NCCL on CUDA, gloo on the
CPU; ``pretrain_gnns_tpu_torch.parallel.multihost``) and train one
``run_pretrain`` together, one device a rank, each on its own column of
batches, the gradients, batch-norm statistics, loss and metrics averaged
over the world at every step (``parallel.dp``). With ``--num_processes
1`` the script still forms a group, of one rank: the data-parallel path
at a world of one, which equals the run without data parallelism bit for
bit.

N ranks, one line a process (``--device cpu`` on a host without a card):

  python scripts/torch_port_multihost_smoke.py --num_processes N \\
      --process_id i --coordinator HOST0:PORT [training flags]

or through a CLI, which calls ``multihost.initialize()`` itself:

  PGT_COORDINATOR=HOST0:PORT PGT_NUM_PROCESSES=N PGT_PROCESS_ID=i \\
      python -m pretrain_gnns_tpu_torch.cli.pretrain --dp_devices N ...

or under torch's launcher (``PGT_NUM_PROCESSES=auto`` reads its
``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, ``LOCAL_RANK``):

  PGT_NUM_PROCESSES=auto torchrun --nproc_per_node N \\
      -m pretrain_gnns_tpu_torch.cli.pretrain --dp_devices N ...

Two CPU ranks (gloo):

  for i in 0 1; do python scripts/torch_port_multihost_smoke.py \\
      --device cpu --num_processes 2 --process_id $i \\
      --coordinator 127.0.0.1:29511 --out run & done; wait

``--out PATH`` dumps rank 0's per-epoch losses, edges and steps
(``PATH.json``) and its final parameters and buffers (``PATH.npz``, by
state-dict name), so that a run can be compared leaf for leaf with
another: with a single-process run, or with the JAX package's.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--coordinator", default="127.0.0.1:9955",
                    help="HOST:PORT of rank 0, or a tcp:// or file:// URL")
    ap.add_argument("--num_processes", type=int, default=1)
    ap.add_argument("--process_id", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (NCCL, card LOCAL_RANK) or cpu (gloo)")
    ap.add_argument("--objective", default="masking")
    ap.add_argument("--domain", default="chem", choices=["chem", "bio"])
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--num_layer", type=int, default=2)
    ap.add_argument("--emb_dim", type=int, default=32)
    ap.add_argument("--n_graphs", type=int, default=640)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dropout_ratio", type=float, default=0.0)
    ap.add_argument("--packing", default="auto",
                    choices=["auto", "standard", "blocked"])
    ap.add_argument("--device_dataset", default="on",
                    choices=["auto", "on", "off"])
    ap.add_argument("--transform_device", default="batch",
                    choices=["auto", "host", "batch", "device"])
    ap.add_argument("--scan_steps", type=int, default=4)
    ap.add_argument("--epoch_group", type=int, default=0)
    ap.add_argument("--checkpoint_dir", default="")
    ap.add_argument("--checkpoint_every", type=int, default=0)
    ap.add_argument("--out", default="")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)

    import numpy as np
    import torch

    from pretrain_gnns_tpu_torch.data.synthetic import (
        bio_dataset, molecule_dataset,
    )
    from pretrain_gnns_tpu_torch.parallel import multihost
    from pretrain_gnns_tpu_torch.train import pretrain

    multihost.init_group(multihost.init_method(args.coordinator),
                         args.num_processes, args.process_id, args.device)
    print(f"process {multihost.process_index()}/"
          f"{multihost.process_count()}: 1 local / "
          f"{multihost.process_count()} global devices "
          f"({torch.distributed.get_backend()})", flush=True)
    try:
        # the same seeded dataset on every rank
        if args.domain == "bio":
            graphs = bio_dataset(args.n_graphs, seed=args.seed)
        else:
            graphs, _ = molecule_dataset(args.n_graphs, num_tasks=1,
                                         seed=args.seed, mean_atoms=18)
        num_tasks = 1
        if args.objective == "supervised":
            graphs, num_tasks = pretrain.supervised_graphs(graphs,
                                                           args.domain)
        cfg = pretrain.PretrainConfig(
            objective=args.objective, domain=args.domain,
            num_layer=args.num_layer, emb_dim=args.emb_dim,
            batch_size=args.batch_size, mask_edge=False,
            dropout_ratio=args.dropout_ratio, num_tasks=num_tasks,
            packing=args.packing, transform_device=args.transform_device,
            device_dataset=args.device_dataset, dp_devices=0,
            scan_steps=args.scan_steps, epoch_group=args.epoch_group,
            seed=args.seed, epochs=args.epochs)
        res = pretrain.run_pretrain(
            cfg, graphs, log=lambda m: print(m, flush=True),
            epochs=args.epochs, device=args.device,
            checkpoint_dir=args.checkpoint_dir or None,
            checkpoint_every=args.checkpoint_every)
        if args.out and multihost.is_main():
            np.savez(args.out, **{
                name: v.detach().cpu().numpy()
                for name, v in res["model"].state_dict().items()})
            with open(args.out + ".json", "w") as f:
                hist = res["history"]
                json.dump({"losses": [h["loss"] for h in hist],
                           "edges": [h["edges"] for h in hist],
                           "steps": [h["steps"] for h in hist],
                           "replays": res["replays"],
                           "eager_steps": res["eager_steps"]}, f)
            print(f"wrote {args.out}", flush=True)
        multihost.sync("done")
    finally:
        multihost.shutdown()


if __name__ == "__main__":
    main()
