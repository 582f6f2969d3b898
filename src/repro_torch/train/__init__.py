from .step import make_train_step  # noqa: F401
