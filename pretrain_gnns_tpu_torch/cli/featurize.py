"""Offline featurizer CLI of the port — the reference's ``python
chem/loader.py`` dataset build (create_all_datasets,
chem/loader.py:1295-1322), with the JAX package's flags; it writes the
files that both packages read (``data.datasets``).

  python -m pretrain_gnns_tpu_torch.cli.featurize --dataset tox21 --root dataset

Requires RDKit and raw downloads in <root>/<dataset>/raw/ (the reference's
own raw layout). ``--dataset all`` builds every CSV dataset present.

Migration path: ``--import_pyg <geometric_data_processed.pt>`` converts a
dataset already processed by the unmodified reference (read with
``torch.load(weights_only=True)``, no code of the file run, no PyG needed;
works for chem and bio, incl. the pre-processed-only bio data) —
optionally with ``--smiles_csv <processed/smiles.csv>`` to carry
smiles/scaffolds over.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    from pretrain_gnns_tpu_torch.data import featurize

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset", required=True)
    p.add_argument("--root", default="dataset")
    p.add_argument(
        "--downstream_dirs", nargs="*", default=[],
        help="processed_tpu dirs of downstream sets (chembl leakage filter)",
    )
    p.add_argument(
        "--import_pyg", default=None,
        help="reference processed .pt file to convert instead of raw data",
    )
    p.add_argument(
        "--smiles_csv", default=None,
        help="reference processed/smiles.csv to carry over (with "
             "--import_pyg)",
    )
    args = p.parse_args(argv)

    if args.import_pyg is not None:
        from pretrain_gnns_tpu_torch.compat import import_pyg
        from pretrain_gnns_tpu_torch.data import datasets

        out = datasets.processed_dir(args.root, args.dataset)
        n = import_pyg.import_processed(
            args.import_pyg, out, dataset_name=args.dataset,
            smiles_csv=args.smiles_csv,
        )
        print(f"{args.dataset}: imported {n} graphs -> {out}")
        return

    names = (
        [n for n in featurize.CSV_SPECS
         if os.path.isdir(os.path.join(args.root, n, "raw"))]
        if args.dataset == "all"
        else [args.dataset]
    )
    for name in names:
        n = featurize.process_dataset(
            name, args.root, downstream_dirs=args.downstream_dirs
        )
        print(f"{name}: {n} graphs -> "
              f"{os.path.join(args.root, name, 'processed_tpu')}")


if __name__ == "__main__":
    main()
