from multiclust_tpu_torch.io.dataset import Dataset  # noqa: F401
