from .ops import (cim_mvm, cim_mvm_params, cim_mvm_signed,  # noqa: F401
                  cim_mvm_tiles, CimMvmParams)
