"""Official VQAv2 accuracy protocol (answer normalization and consensus
accuracy), copied from ``certifiedgpt_tpu/vqa_tools/vqa_eval.py`` (pure
Python) so that the port imports nothing of the JAX package.

Answer normalization follows the punctuation/digit/article/contraction
rules of the official scorer (Antol et al.); the consensus accuracy is
``mean_i min(1, #{other humans matching}/3)``, leave-one-out over the
human answers.

The normalizer is also the backbone of the decoder-output->label mapping
used by smoothed certification (SURVEY.md §2.4 note b).
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence

CONTRACTIONS = {
    "aint": "ain't", "arent": "aren't", "cant": "can't", "couldve": "could've",
    "couldnt": "couldn't", "couldn'tve": "couldn't've", "couldnt've": "couldn't've",
    "didnt": "didn't", "doesnt": "doesn't", "dont": "don't", "hadnt": "hadn't",
    "hadnt've": "hadn't've", "hadn'tve": "hadn't've", "hasnt": "hasn't",
    "havent": "haven't", "hed": "he'd", "hed've": "he'd've", "he'dve": "he'd've",
    "hes": "he's", "howd": "how'd", "howll": "how'll", "hows": "how's",
    "Id've": "I'd've", "I'dve": "I'd've", "Im": "I'm", "Ive": "I've",
    "isnt": "isn't", "itd": "it'd", "itd've": "it'd've", "it'dve": "it'd've",
    "itll": "it'll", "let's": "let's", "maam": "ma'am", "mightnt": "mightn't",
    "mightnt've": "mightn't've", "mightn'tve": "mightn't've", "mightve": "might've",
    "mustnt": "mustn't", "mustve": "must've", "neednt": "needn't",
    "notve": "not've", "oclock": "o'clock", "oughtnt": "oughtn't",
    "ow's'at": "'ow's'at", "'ows'at": "'ow's'at", "'ow'sat": "'ow's'at",
    "shant": "shan't", "shed've": "she'd've", "she'dve": "she'd've",
    "she's": "she's", "shouldve": "should've", "shouldnt": "shouldn't",
    "shouldnt've": "shouldn't've", "shouldn'tve": "shouldn't've",
    "somebody'd": "somebodyd", "somebodyd've": "somebody'd've",
    "somebody'dve": "somebody'd've", "somebodyll": "somebody'll",
    "somebodys": "somebody's", "someoned": "someone'd",
    "someoned've": "someone'd've", "someone'dve": "someone'd've",
    "someonell": "someone'll", "someones": "someone's", "somethingd": "something'd",
    "somethingd've": "something'd've", "something'dve": "something'd've",
    "somethingll": "something'll", "thats": "that's", "thered": "there'd",
    "thered've": "there'd've", "there'dve": "there'd've", "therere": "there're",
    "theres": "there's", "theyd": "they'd", "theyd've": "they'd've",
    "they'dve": "they'd've", "theyll": "they'll", "theyre": "they're",
    "theyve": "they've", "twas": "'twas", "wasnt": "wasn't",
    "wed've": "we'd've", "we'dve": "we'd've", "weve": "we've", "werent": "weren't",
    "whatll": "what'll", "whatre": "what're", "whats": "what's", "whatve": "what've",
    "whens": "when's", "whered": "where'd", "wheres": "where's",
    "whereve": "where've", "whod": "who'd", "whod've": "who'd've",
    "who'dve": "who'd've", "wholl": "who'll", "whos": "who's", "whove": "who've",
    "whyll": "why'll", "whyre": "why're", "whys": "why's", "wont": "won't",
    "wouldve": "would've", "wouldnt": "wouldn't", "wouldnt've": "wouldn't've",
    "wouldn'tve": "wouldn't've", "yall": "y'all", "yall'll": "y'all'll",
    "y'allll": "y'all'll", "yall'd've": "y'all'd've", "y'alld've": "y'all'd've",
    "y'all'dve": "y'all'd've", "youd": "you'd", "youd've": "you'd've",
    "you'dve": "you'd've", "youll": "you'll", "youre": "you're", "youve": "you've",
}

DIGIT_MAP = {
    "none": "0", "zero": "0", "one": "1", "two": "2", "three": "3", "four": "4",
    "five": "5", "six": "6", "seven": "7", "eight": "8", "nine": "9", "ten": "10",
}

ARTICLES = {"a", "an", "the"}

_PERIOD_STRIP = re.compile(r"(?!<=\d)(\.)(?!\d)")
_COMMA_STRIP = re.compile(r"(\d)(,)(\d)")
_PUNCT = [
    ";", r"/", "[", "]", '"', "{", "}", "(", ")", "=", "+", "\\", "_", "-",
    ">", "<", "@", "`", ",", "?", "!",
]


def process_punctuation(text: str) -> str:
    out = text
    for p in _PUNCT:
        if (p + " " in text or " " + p in text) or (
            _COMMA_STRIP.search(text) is not None
        ):
            out = out.replace(p, "")
        else:
            out = out.replace(p, " ")
    out = _PERIOD_STRIP.sub("", out, re.UNICODE)
    return out


def process_digit_article(text: str) -> str:
    out: List[str] = []
    for word in text.lower().split():
        word = DIGIT_MAP.get(word, word)
        if word not in ARTICLES:
            out.append(word)
    for i, word in enumerate(out):
        if word in CONTRACTIONS:
            out[i] = CONTRACTIONS[word]
    return " ".join(out)


def normalize_answer(answer: str) -> str:
    """Full official normalization pipeline for one answer string."""
    answer = answer.replace("\n", " ").replace("\t", " ").strip()
    answer = process_punctuation(answer)
    answer = process_digit_article(answer)
    return answer


class VQAEval:
    """Consensus accuracy over (prediction, 10-human-answers) pairs.

    ``n`` controls reported rounding precision (the reference uses n=2).
    """

    def __init__(self, vqa=None, vqa_res=None, n: int = 2):
        self.n = n
        self.vqa = vqa
        self.vqa_res = vqa_res
        self.accuracy: Dict[str, object] = {}
        self.eval_qa: Dict[int, float] = {}
        self.eval_ques_type: Dict[str, Dict[int, float]] = {}
        self.eval_ans_type: Dict[str, Dict[int, float]] = {}

    # ------------------------------------------------------------------
    @staticmethod
    def answer_accuracy(prediction: str, gt_answers: Sequence[str]) -> float:
        """min(1, matches/3) averaged leave-one-out over the human answers.

        Protocol quirks preserved from the official scorer: the prediction
        gets the full normalization; ground-truth answers get punctuation
        processing only, and only when the humans disagree; leave-one-out
        is positional.
        """
        pred = normalize_answer(prediction)
        gts = list(gt_answers)
        if not gts:
            return 0.0
        if len(set(gts)) > 1:
            gts = [process_punctuation(a) for a in gts]
        accs = []
        for i in range(len(gts)):
            others = gts[:i] + gts[i + 1 :]
            matching = sum(1 for o in others if o == pred)
            accs.append(min(1.0, matching / 3.0))
        return float(sum(accs) / len(accs))

    # ------------------------------------------------------------------
    def evaluate(self, ques_ids: Optional[Sequence[int]] = None) -> Dict[str, object]:
        """Score ``vqa_res`` predictions against ``vqa`` ground truth
        (same call surface as the official scorer)."""
        if self.vqa is None or self.vqa_res is None:
            raise ValueError("VQAEval.evaluate needs the ground truth and the results")
        if ques_ids is None:
            ques_ids = list(self.vqa.get_ques_ids())
        per_type: Dict[str, List[float]] = {}
        per_ans_type: Dict[str, List[float]] = {}
        all_acc: List[float] = []

        for qid in ques_ids:
            gt = self.vqa.load_qa(qid)
            res = self.vqa_res.load_qa(qid)
            gt_answers = [a["answer"] for a in gt["answers"]]
            acc = self.answer_accuracy(res["answer"], gt_answers)
            self.eval_qa[qid] = round(100.0 * acc, self.n)
            all_acc.append(acc)
            q_type = gt.get("question_type", "unknown")
            a_type = gt.get("answer_type", "unknown")
            per_type.setdefault(q_type, []).append(acc)
            per_ans_type.setdefault(a_type, []).append(acc)
            self.eval_ques_type.setdefault(q_type, {})[qid] = round(100.0 * acc, self.n)
            self.eval_ans_type.setdefault(a_type, {})[qid] = round(100.0 * acc, self.n)

        self.accuracy = {
            "overall": round(100.0 * sum(all_acc) / max(len(all_acc), 1), self.n),
            "perQuestionType": {
                k: round(100.0 * sum(v) / len(v), self.n) for k, v in per_type.items()
            },
            "perAnswerType": {
                k: round(100.0 * sum(v) / len(v), self.n) for k, v in per_ans_type.items()
            },
        }
        return self.accuracy
