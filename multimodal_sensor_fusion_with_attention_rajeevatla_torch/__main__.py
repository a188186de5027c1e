"""``python -m multimodal_sensor_fusion_with_attention_rajeevatla_torch train|eval ...``"""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
