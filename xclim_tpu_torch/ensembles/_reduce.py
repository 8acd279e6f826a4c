"""Ensemble member selection (reference: xclim:src/xclim/ensembles/_reduce.py).

Host-side algorithms (member counts are small); KKZ and KMeans selection."""

from __future__ import annotations

import numpy as np
import torch

from xclim_tpu_torch.core.dataarray import ClimArray, ClimDataset

__all__ = ["kkz_reduce_ensemble", "kmeans_reduce_ensemble", "make_criteria",
           "plot_rsqprofile"]


def make_criteria(ds: ClimDataset | ClimArray) -> ClimArray:
    """Stack all variables/points into a (realization, criteria) matrix
    (xclim:ensembles/_reduce.py:26)."""
    if isinstance(ds, ClimArray):
        arrays = [ds]
    else:
        arrays = list(ds.values())
    rows = []
    for a in arrays:
        rax = a.dims.index("realization")
        d = np.moveaxis(np.asarray(a.values, dtype=np.float64), rax, 0)
        rows.append(d.reshape(d.shape[0], -1))
    crit = np.concatenate(rows, axis=1)
    # drop criteria with any NaN (reference stacks then drops all-nan)
    keep = ~np.isnan(crit).any(axis=0)
    crit = crit[:, keep]
    # a float64 tensor keeps the criteria in double, as the reference's
    # numpy data does
    return ClimArray(torch.as_tensor(crit, device=arrays[0].device),
                     ("realization", "criteria"),
                     {"realization": np.arange(crit.shape[0]),
                      "criteria": np.arange(crit.shape[1])}, {}, "criteria")


def _crit_matrix(data) -> np.ndarray:
    if isinstance(data, ClimArray):
        m = np.asarray(data.values, dtype=np.float64)
    else:
        m = np.asarray(data, dtype=np.float64)
    if m.ndim != 2:
        raise ValueError("criteria must be 2-D (realization, criteria)")
    return m


def kkz_reduce_ensemble(data, num_select: int, *, dist_method: str = "euclidean",
                        standardize: bool = True) -> list[int]:
    """Katsavounidis-Kuo-Zhang selection: start at the member closest to the
    centroid, then greedily add the member farthest from the selected set
    (xclim:ensembles/_reduce.py:104)."""
    crit = _crit_matrix(data)
    if standardize:
        std = crit.std(axis=0)
        std[std == 0] = 1
        crit = (crit - crit.mean(axis=0)) / std
    n = crit.shape[0]
    centroid = crit.mean(axis=0)
    d0 = np.linalg.norm(crit - centroid, axis=1)
    selected = [int(np.argmin(d0))]
    while len(selected) < min(num_select, n):
        dists = np.stack([np.linalg.norm(crit - crit[s], axis=1) for s in selected])
        mindist = dists.min(axis=0)
        mindist[selected] = -np.inf
        selected.append(int(np.argmax(mindist)))
    return selected


def kmeans_reduce_ensemble(data, *, method: dict | None = None, make_graph: bool = False,
                           max_clusters: int | None = None, variable_weights=None,
                           model_weights=None, sample_weights=None,
                           random_state=None) -> tuple[list[int], np.ndarray, dict]:
    """K-means clustering selection, one member per cluster (closest to its
    centroid) (xclim:ensembles/_reduce.py:177)."""
    from sklearn.cluster import KMeans

    crit = _crit_matrix(data)
    n = crit.shape[0]
    std = crit.std(axis=0)
    std[std == 0] = 1
    z = (crit - crit.mean(axis=0)) / std
    if variable_weights is not None:
        z = z * np.asarray(variable_weights)

    method = method or {"n_clusters": max(n // 4, 2)}
    rsq = None
    if "rsq_cutoff" in method or "rsq_optimize" in method or make_graph:
        # R² profile over cluster counts
        max_k = max_clusters or n
        inertias = []
        for k in range(1, max_k + 1):
            km = KMeans(n_clusters=k, n_init=10, random_state=random_state).fit(
                z, sample_weight=model_weights)
            inertias.append(km.inertia_)
        tot = inertias[0]
        rsq = 1 - np.asarray(inertias) / (tot if tot else 1)
    if "rsq_cutoff" in method or "rsq_optimize" in method:
        if "rsq_cutoff" in method:
            n_clusters = int(np.searchsorted(rsq, method["rsq_cutoff"]) + 1)
        else:
            # maximize distance to the no-skill line (optimize)
            ks = np.arange(1, max_k + 1)
            line = rsq[0] + (rsq[-1] - rsq[0]) * (ks - 1) / max(max_k - 1, 1)
            n_clusters = int(np.argmax(rsq - line) + 1)
    else:
        n_clusters = int(method.get("n_clusters", max(n // 4, 2)))
    if max_clusters is not None:
        n_clusters = min(n_clusters, max_clusters)
    n_clusters = max(1, min(n_clusters, n))

    km = KMeans(n_clusters=n_clusters, n_init=10, random_state=random_state)
    labels = km.fit_predict(z, sample_weight=model_weights)
    ids = []
    for c in range(n_clusters):
        members = np.nonzero(labels == c)[0]
        d = np.linalg.norm(z[members] - km.cluster_centers_[c], axis=1)
        if sample_weights is not None:
            d = d / np.asarray(sample_weights)[members]
        ids.append(int(members[np.argmin(d)]))
    fig_data = {"method": dict(method), "rsq": rsq, "realizations": n,
                "n_clusters": n_clusters}
    if max_clusters is not None:
        fig_data["max_clusters"] = max_clusters
    return sorted(ids), labels, fig_data


def plot_rsqprofile(fig_data: dict):
    """R² profile plot from ``kmeans_reduce_ensemble(make_graph=True)``
    output (xclim:ensembles/_reduce.py:451): R² of k clusters vs the full
    ensemble, with the selection marked per method."""
    try:
        import matplotlib.pyplot as plt
    except ImportError as err:  # pragma: no cover - mpl is present in CI
        raise ModuleNotFoundError(
            "Matplotlib is not installed. No plotting functions are "
            "supported.") from err

    rsq = np.asarray(fig_data["rsq"], dtype=float)
    n_sim = fig_data["realizations"]
    n_clusters = fig_data["n_clusters"]
    plt.figure(figsize=(10, 6))
    plt.plot(range(1, len(rsq) + 1), rsq, "k-o", label="R²",
             linewidth=0.8, markersize=4)
    axes = plt.gca()
    axes.set_xlim([0, n_sim])
    axes.set_ylim([0, 1])
    plt.xlabel("Number of groups")
    plt.ylabel("R²")
    plt.title("R² of groups vs. full ensemble")
    method = fig_data.get("method", {})
    if "rsq_cutoff" in method:
        col, label = "k--", (f"R² selection > {method['rsq_cutoff']} "
                             f"(n = {n_clusters})")
        if "max_clusters" in fig_data and rsq[n_clusters - 1] < method["rsq_cutoff"]:
            col = "r--"
            label = (f"R² selection = {rsq[n_clusters - 1].round(2)} "
                     f"(n = {n_clusters}) : max_clusters = "
                     f"{fig_data['max_clusters']}")
        plt.plot((0, n_clusters, n_clusters),
                 (rsq[n_clusters - 1], rsq[n_clusters - 1], 0), col,
                 label=label, linewidth=0.75)
    elif "rsq_optimize" in method:
        onetoone = (-1.0 / (n_sim - 1)
                    + np.arange(1, n_sim + 1) * (1.0 / (n_sim - 1)))
        plt.plot(range(1, min(len(rsq), n_sim) + 1),
                 onetoone[:len(rsq)], color=[0.25, 0.25, 0.75],
                 label="Theoretical constant increase in R²", linewidth=0.5)
        plt.plot((0, n_clusters, n_clusters),
                 (rsq[n_clusters - 1], rsq[n_clusters - 1], 0), "k--",
                 label=f"Optimized R² cost / benefit (n = {n_clusters})",
                 linewidth=0.75)
    else:
        plt.plot((0, n_clusters, n_clusters),
                 (rsq[n_clusters - 1], rsq[n_clusters - 1], 0), "k--",
                 label=f"n = {n_clusters} (user defined)", linewidth=0.75)
    plt.legend(loc="lower right")
