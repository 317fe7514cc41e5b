from splatam_torch.fisher.fisher import (
    eig_score,
    fisher_gains_batch,
    fisher_h_train,
    h_train_inverse,
    nonlinear_gain,
    render_fisher,
    render_gains,
    silhouette_gain,
    sized_fisher_config,
)

__all__ = [
    "eig_score",
    "fisher_gains_batch",
    "fisher_h_train",
    "h_train_inverse",
    "nonlinear_gain",
    "render_fisher",
    "render_gains",
    "silhouette_gain",
    "sized_fisher_config",
]
