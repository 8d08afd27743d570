"""CLI entry point: ``python -m dca_tpu_torch <input> <outputdir>``.

The flag surface of the JAX package's CLI (``dca_tpu/__main__.py``: names,
defaults, paired --x/--no-x booleans), plus ``--device``: the run goes to
the CUDA device unless ``--device cpu`` is given.  ``--devices`` trains data
parallel over a rank per device: ``python -m dca_tpu_torch in.tsv out/
--devices N`` (or ``all``) starts them from this one process
(``parallel/launch.py``; with ``--device cpu``, N gloo ranks), and
``torchrun --nproc-per-node N -m dca_tpu_torch in.tsv out/ --devices all``
runs under torchrun's ranks instead (rank 0 writes the outputs either way).  ``--saveweights`` writes the best epoch's
``weights.hdf5`` (needs h5py) and ``--tensorboard`` the event files and a
profiler trace under ``<outputdir>/tb``.  ``--hyper`` runs the TPE search
of ``hyper.py`` instead of one fit (``--hypern`` trials of ``--hyperepoch``
epochs), writing ``<outputdir>/hyperopt_results/{trials.pickle,best.json}``;
DCA_TPU_HYPER_PARALLEL trials run at once (default: the CUDA device count
when above 1, else 2).  ``--modelparallel M`` with ``--devices`` lays
the ranks out as a (ranks / M) x M grid and shards the gene dimension of
the input and head weights over M of them: ``python -m dca_tpu_torch
in.tsv out/ --devices 4 --modelparallel 2``, in memory or streamed.
Every ``--type``, ``--activation`` (PReLU included) and ``--optimizer``
(SGD, RMSprop, Adam, Adamax, Nadam, Adagrad, Adadelta) of the JAX package
runs; the input is read and the TSVs are written through the native C++
tier (``dca_tpu_torch/native``); ``--outputformat h5ad`` writes
``denoised.h5ad`` through the streaming writer.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Autoencoder")

    parser.add_argument(
        "input",
        type=str,
        help="Path to the raw count matrix: a TSV/CSV table or an H5AD file, "
        "with row and column names present. Text tables are expected gene-wise "
        "(one row per gene, one column per cell); pass -t/--transpose when "
        "yours is cell x gene instead. H5AD input always follows the "
        "AnnData/scanpy orientation, cells in rows and genes in columns.",
    )
    parser.add_argument("outputdir", type=str,
                        help="Directory where result TSVs and model artifacts are written")

    # IO and norm options
    parser.add_argument(
        "--normtype",
        type=str,
        default="zheng",
        help="Size-factor estimation scheme, 'deseq' or 'zheng'. Accepted for "
        "command-line compatibility but not consumed. (default: zheng)",
    )
    parser.add_argument(
        "-t", "--transpose", dest="transpose", action="store_true",
        help="Treat the input table as cell x gene and transpose it on load "
        "(default: False)",
    )
    parser.add_argument(
        "--testsplit", dest="testsplit", action="store_true",
        help="Hold out 10%% of cells as a test fold, recorded in "
        "obs['dca_split'] (default: False)",
    )

    # training options
    parser.add_argument(
        "--type", type=str, default="nb-conddisp",
        help="Noise-model / architecture variant: normal, poisson, nb, "
        "nb-conddisp (default), nb-shared, nb-fork, zinb, zinb-conddisp, "
        "zinb-shared, zinb-fork or zinb-elempi",
    )
    parser.add_argument(
        "--threads", type=int, default=None,
        help="Host thread cap for CPU execution; unset means use every core",
    )
    parser.add_argument("-b", "--batchsize", type=int, default=32,
                        help="Minibatch size for training (default:32)")
    parser.add_argument("--sizefactors", dest="sizefactors", action="store_true",
                        help="Scale the predicted means by per-cell library size "
                        "factors (default: True)")
    parser.add_argument("--nosizefactors", dest="sizefactors", action="store_false",
                        help="Skip library-size scaling of the means")
    parser.add_argument("--norminput", dest="norminput", action="store_true",
                        help="Standardize (z-scale) the model input (default: True)")
    parser.add_argument("--nonorminput", dest="norminput", action="store_false",
                        help="Skip input standardization")
    parser.add_argument("--loginput", dest="loginput", action="store_true",
                        help="Apply log1p to the model input (default: True)")
    parser.add_argument("--nologinput", dest="loginput", action="store_false",
                        help="Skip the log1p input transform")
    parser.add_argument("-d", "--dropoutrate", type=str, default="0.0",
                        help="Hidden-layer dropout rate; a comma-separated list "
                        "sets one rate per layer (default: 0)")
    parser.add_argument("--batchnorm", dest="batchnorm", action="store_true",
                        help="Insert batch normalization after each hidden dense "
                        "layer (default: True)")
    parser.add_argument("--nobatchnorm", dest="batchnorm", action="store_false",
                        help="Disable batch normalization")
    parser.add_argument("--l2", type=float, default=0.0,
                        help="L2 weight penalty applied to every dense layer (default: 0.0)")
    parser.add_argument("--l1", type=float, default=0.0,
                        help="L1 weight penalty applied to every dense layer (default: 0.0)")
    parser.add_argument("--l2enc", type=float, default=0.0,
                        help="L2 weight penalty override for the encoder/bottleneck "
                        "stages only (default: 0.0)")
    parser.add_argument("--l1enc", type=float, default=0.0,
                        help="L1 weight penalty override for the encoder/bottleneck "
                        "stages only (default: 0.0)")
    parser.add_argument("--ridge", type=float, default=0.0,
                        help="Ridge penalty on the ZINB dropout probabilities pi "
                        "(default: 0.0)")
    parser.add_argument("--gradclip", type=float, default=5.0,
                        help="Elementwise gradient-value clipping threshold (default: 5.0)")
    parser.add_argument("--activation", type=str, default="relu",
                        help="Nonlinearity for the hidden layers (default: relu)")
    parser.add_argument("--optimizer", type=str, default="RMSprop",
                        help="Optimizer name, resolved case-insensitively "
                        "(default: RMSprop)")
    parser.add_argument("--init", type=str, default="glorot_uniform",
                        help="Weight initializer for the dense layers "
                        "(default: glorot_uniform)")
    parser.add_argument("-e", "--epochs", type=int, default=300,
                        help="Upper bound on training epochs; early stopping "
                        "usually ends the run sooner (default: 300)")
    parser.add_argument("--earlystop", type=int, default=15,
                        help="Patience in epochs before training stops when the "
                        "validation loss plateaus (default: 15)")
    parser.add_argument("--reducelr", type=int, default=10,
                        help="Patience in epochs before the learning rate is cut "
                        "when the validation loss plateaus (default: 10)")
    parser.add_argument("-s", "--hiddensize", type=str, default="64,32,64",
                        help="Comma-separated widths of the hidden layers; the "
                        "middle entry is the bottleneck (default: 64,32,64)")
    parser.add_argument("--inputdropout", type=float, default=0.0,
                        help="Dropout rate applied directly to the input layer")
    parser.add_argument("-r", "--learningrate", type=float, default=None,
                        help="Initial learning rate (default: 0.001)")
    parser.add_argument("--saveweights", dest="saveweights", action="store_true",
                        help="Checkpoint the best-validation weights to the output "
                        "directory (default: False)")
    parser.add_argument("--no-saveweights", dest="saveweights", action="store_false",
                        help="Skip weight checkpointing")
    parser.add_argument("--hyper", dest="hyper", action="store_true",
                        help="Run the hyperparameter search instead of a single "
                        "training run (default: False)")
    parser.add_argument("--hypern", dest="hypern", type=int, default=1000,
                        help="Trial budget for the hyperparameter search "
                        "(default: 1000)")
    parser.add_argument("--hyperepoch", dest="hyperepoch", type=int, default=100,
                        help="Training epochs per hyperparameter trial "
                        "(default: 100)")
    parser.add_argument("--debug", dest="debug", action="store_true",
                        help="Numerical sanitizer: verify every loss term stays "
                        "finite each step and abort with the failing term "
                        "otherwise. (default: False)")
    parser.add_argument("--tensorboard", dest="tensorboard", action="store_true",
                        help="TensorBoard logging of training (default: False)")
    parser.add_argument("--checkcounts", dest="checkcounts", action="store_true",
                        help="Verify the input looks like raw integer counts before "
                        "training (default: True)")
    parser.add_argument("--nocheckcounts", dest="checkcounts", action="store_false",
                        help="Skip the raw-count sanity check")
    parser.add_argument("--denoisesubset", dest="denoisesubset", type=str,
                        help="Restrict denoising to the genes named in this file, "
                        "one gene per line.")

    parser.add_argument("--devices", dest="devices", type=str, default=None,
                        help="Train data parallel on several devices, one rank "
                        "each: 'all' or their number; the ranks start from this "
                        "process, or run under torchrun (default: one device)")
    parser.add_argument("--modelparallel", dest="modelparallel", type=int, default=1,
                        help="Width of the model axis of the device mesh: shard "
                        "the gene dimension of the input/head weight matrices "
                        "over this many ranks (default: 1, pure data "
                        "parallelism). Requires --devices.")
    parser.add_argument("--outputformat", dest="outputformat", type=str,
                        default="tsv", choices=("tsv", "h5ad"),
                        help="Output format: 'tsv' is the reference TSV "
                        "contract; 'h5ad' writes one denoised.h5ad (X = "
                        "denoised, obsm/var layers) through the streaming "
                        "writer (default: tsv)")
    parser.add_argument("--device", dest="device", type=str, default=None,
                        choices=("cuda", "cpu"),
                        help="Device to run on (default: cuda; with no CUDA "
                        "device the run stops unless --device cpu is given)")

    parser.set_defaults(
        transpose=False,
        testsplit=False,
        saveweights=False,
        sizefactors=True,
        batchnorm=True,
        checkcounts=True,
        norminput=True,
        hyper=False,
        debug=False,
        tensorboard=False,
        loginput=True,
    )

    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    # heavy imports after argparse for a fast -h
    from .train.loop import train_with_args

    train_with_args(args)


if __name__ == "__main__":
    main()
