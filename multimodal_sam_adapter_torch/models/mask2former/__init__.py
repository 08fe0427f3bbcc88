from .head import Mask2FormerHead, MaskFormerHead, semantic_inference
from .losses import (PointDraws, draw_points, mask2former_loss,
                     match_queries)
from .matching import (classification_cost, dice_cost, hungarian_assign,
                       mask_bce_cost)
from .pixel_decoder import MSDeformAttnPixelDecoder
from .positional_encoding import SinePositionalEncoding
from .transformer_decoder import Mask2FormerDecoder
