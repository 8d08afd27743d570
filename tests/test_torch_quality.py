"""The denoising-quality oracle of tests/test_quality.py on the port's
``dca()`` on the CPU, with the same data, seeds, sizes and thresholds: the
silhouette of PCA(denoised) must beat that of the noisy counts by 0.15 and
reach 0.8 of the true counts', and the latent space must separate the
groups (silhouette above 0.06).  ``chip_smoke.py`` phase 12 (e) runs the
same checks on the card, with its copy of the generator and, where sklearn
is missing, its numpy silhouette, both held here to the originals."""

import numpy as np
import pandas as pd
import torch
from sklearn.decomposition import PCA
from sklearn.metrics import silhouette_score

import chip_smoke
from dca_tpu_torch import dca
from dca_tpu_torch.data.adata import AnnData
from test_quality import _silhouette, make_grouped_counts

torch.set_num_threads(1)  # tier-1 runs several pytest workers at once


def test_denoising_improves_silhouette():
    noisy, true_counts, groups = make_grouped_counts()
    adata = AnnData(
        noisy.copy(),
        pd.DataFrame(index=pd.Index([f"c{i}" for i in range(noisy.shape[0])])),
        pd.DataFrame(index=pd.Index([f"g{i}" for i in range(noisy.shape[1])])),
    )
    ret = dca(adata, mode="denoise", ae_type="zinb-conddisp", copy=True, epochs=80,
              verbose=False, random_state=0, device="cpu")
    sil_noisy = _silhouette(noisy, groups)
    sil_denoised = _silhouette(ret.X, groups)
    sil_true = _silhouette(true_counts, groups)
    print(f"silhouette noisy={sil_noisy:.3f} denoised={sil_denoised:.3f} true={sil_true:.3f}")
    assert sil_denoised > sil_noisy + 0.15, (sil_noisy, sil_denoised)
    assert sil_denoised > 0.8 * sil_true, (sil_denoised, sil_true)


def test_latent_space_separates_groups():
    noisy, _, groups = make_grouped_counts(seed=7)
    ret = dca(AnnData(noisy.copy()), mode="latent", copy=True, epochs=80, verbose=False,
              random_state=0, device="cpu")
    sil_latent = silhouette_score(ret.obsm["X_dca"], groups)
    assert sil_latent > 0.06, sil_latent


def test_chip_smoke_copies_the_oracle():
    """phase 12 (e)'s generator is tests/test_quality.py's, and its numpy
    silhouette gives sklearn's to 1e-9, and its exact PCA (sklearn's full,
    arpack and covariance solvers give the same silhouettes to 1e-8) those
    of sklearn's default within 2e-3: at 600 x 120 sklearn takes its
    randomized solver, an approximation, 5.8e-5 and 1.05e-3 from the exact
    on the noisy and the true counts."""
    for seed in (42, 7):
        for a, b in zip(chip_smoke.make_grouped_counts(seed=seed),
                        make_grouped_counts(seed=seed)):
            np.testing.assert_array_equal(a, b)
    noisy, true_counts, groups = make_grouped_counts()
    for X in (noisy, true_counts):
        Xl = np.log1p(X)
        p = PCA(n_components=10, random_state=0).fit_transform(Xl)
        assert abs(chip_smoke.silhouette_score(p, groups) - silhouette_score(p, groups)) < 1e-9
        assert abs(chip_smoke.silhouette_score(chip_smoke.pca(Xl), groups)
                   - _silhouette(X, groups)) < 2e-3
