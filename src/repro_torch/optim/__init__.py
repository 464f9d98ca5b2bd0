from .adamw import (AdamWState, adamw_init, adamw_state_specs,  # noqa
                    adamw_update, clip_by_global_norm)
