from a3gc_tpu_torch.smpl.armature import (  # noqa: F401
    SMPL_PARENT, MANOJoint, SMPLHJoint, SMPLJoint)
from a3gc_tpu_torch.smpl.model import (  # noqa: F401
    ParametricModel, load_parametric_model)
from a3gc_tpu_torch.smpl.synthetic import (  # noqa: F401
    synthetic_smpl_data, write_synthetic_smpl_pickle)

__all__ = ["SMPL_PARENT", "MANOJoint", "SMPLHJoint", "SMPLJoint",
           "ParametricModel", "load_parametric_model",
           "synthetic_smpl_data", "write_synthetic_smpl_pickle"]
