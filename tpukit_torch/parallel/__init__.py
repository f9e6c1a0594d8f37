"""The device mesh: positions on the cards, each with its own stream."""
from tpukit_torch.parallel.mesh import (Mesh, Position, make_mesh,
                                        run_sharded_batch,
                                        sharded_analysis_step)
