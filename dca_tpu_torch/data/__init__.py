from .adata import AnnData, Raw, is_anndata_like, read_h5ad, write_h5ad
from .io import (
    filter_cells,
    filter_genes,
    log1p,
    normalize,
    normalize_per_cell,
    read_any,
    read_dataset,
    read_genelist,
    read_pickle,
    read_text,
    scale,
    write_text_matrix,
)
from .simulate import Simulation, simulate_counts, simulation_grid

__all__ = [
    "simulate_counts",
    "simulation_grid",
    "Simulation",
    "AnnData",
    "Raw",
    "read_h5ad",
    "write_h5ad",
    "is_anndata_like",
    "read_dataset",
    "read_text",
    "read_any",
    "normalize",
    "normalize_per_cell",
    "filter_genes",
    "filter_cells",
    "log1p",
    "scale",
    "read_genelist",
    "write_text_matrix",
    "read_pickle",
]
