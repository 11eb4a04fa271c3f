from repro_torch.train.steps import (ClientMesh, FLTrainStep, MeshTopology,
                                     draw_omega, make_fl_train_step,
                                     make_fused_step, make_plain_step,
                                     make_two_phase_step)

__all__ = ["ClientMesh", "FLTrainStep", "MeshTopology", "draw_omega",
           "make_fl_train_step", "make_fused_step", "make_plain_step",
           "make_two_phase_step"]
