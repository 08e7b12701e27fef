"""Networks of the port (NCHW ``nn.Module``s in the reference ``.pth``
state_dict layout)."""

from .cyclegan import GeneratorResNet, PatchGANDiscriminator  # noqa: F401
from .depth_decoder import DepthDecoder  # noqa: F401
from .pose_cnn import PoseCNN  # noqa: F401
from .pose_decoder import PoseDecoder  # noqa: F401
from .resnet import ResnetEncoder  # noqa: F401
