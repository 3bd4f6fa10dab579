from .actionness import ActionnessScorer
from .scorer import ProposalScorer, ScoredVideo, score_videos, dump_scores_pickle
