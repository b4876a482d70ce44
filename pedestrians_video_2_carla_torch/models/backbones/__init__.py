"""Image backbones (NCHW)."""
from .resnet import ResNet, import_torchvision_resnet, resnet50, resnet101
