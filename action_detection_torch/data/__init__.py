from .proposal_io import load_proposal_file
