from ahrag_tpu_torch.eval.answer_eval import AnswerEvaluator, normalize_text, squad_f1_em
from ahrag_tpu_torch.eval.retrieval import hit_rate_at_k, recall_at_k
