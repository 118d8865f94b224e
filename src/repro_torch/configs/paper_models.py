"""The paper's own FL client models: small CNN and MLP (AsyncFLEO §V-A).

These are the models the paper trains on MNIST/CIFAR-10 across 40 satellites.
They are not ModelConfig transformers; they live in ``repro_torch.models.cnn``.
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class SmallNetConfig:
    name: str
    kind: str                 # cnn | mlp
    image_size: int = 28
    channels: int = 1
    num_classes: int = 10
    hidden: int = 128
    conv_channels: tuple = (16, 32)


MNIST_CNN = SmallNetConfig("mnist-cnn", "cnn", 28, 1)
MNIST_MLP = SmallNetConfig("mnist-mlp", "mlp", 28, 1, hidden=256)
CIFAR_CNN = SmallNetConfig("cifar-cnn", "cnn", 32, 3, conv_channels=(32, 64))
CIFAR_MLP = SmallNetConfig("cifar-mlp", "mlp", 32, 3, hidden=256)
