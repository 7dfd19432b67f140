"""Mandarin tone sandhi (behavioral reference: text/tone_sandhi.py:466-776,
originally from PaddleSpeech, Apache-2.0).

Rules implemented, applied per segmented word in this order (modified_tone):
  1. 不 sandhi  — bu4 -> bu2 before tone 4; neutral inside X不X.
  2. 一 sandhi  — yi1 -> yi2 before tone 4, yi4 otherwise; neutral in X一X;
                  literal in ordinals / digit strings.
  3. neutral tone — particles (吧呢啊…/的地得/们子/上下里/来去), 量词 个, and a
                  lexicon of standard neutral-tone words.
  4. third-tone sandhi — 3-3 -> 2-3 with jieba-driven word splitting for 3-
                  and 4-char groups.
plus pre-segmentation merges (pre_merge): 不/一 attach to neighbors, 儿 erhua
attaches left, reduplications merge, and adjacent all-tone-3 words merge.

The neutral-tone word lists are curated here independently; they describe
standard-Mandarin lexical facts and can be extended freely.
"""

from __future__ import annotations

from typing import Callable, List, Tuple

Seg = List[Tuple[str, str]]

# Common lexically neutral-tone (轻声) disyllables: second syllable reads
# neutral. Extend as needed.
NEUTRAL_TONE_WORDS = frozenset(
    """
    妈妈 爸爸 哥哥 弟弟 姐姐 妹妹 奶奶 爷爷 叔叔 婶婶 舅舅 姑姑 太太 先生们
    孩子 儿子 女儿 丫头 娃娃 宝宝 媳妇 老婆 老爷 老头 老太 姑娘 师傅 徒弟
    朋友 亲戚 街坊 邻居 大夫 木匠 铁匠 裁缝 财主 衙门 道士 和尚 喇嘛 太监
    东西 事情 时候 地方 名字 样子 架子 份量 动静 功夫 本事 主意 意思 记性
    脾气 性子 胆子 面子 日子 号子 调子 点子 方子 路子 园子 院子 屋子 村子
    身子 脑袋 眼睛 耳朵 鼻子 嘴巴 舌头 眉毛 头发 胡子 脖子 肩膀 胳膊 拳头
    指头 骨头 脊梁 屁股 尾巴 翅膀 爪子 犄角 心思 力气 精神 痛快 运气 福气
    阔气 志气 义气 和气 客气 秀气 神气 晦气 娇气 丧气 胆量 热闹 动弹 衣服
    衣裳 袜子 鞋子 帽子 袍子 褂子 裤子 被子 毯子 垫子 帘子 幌子 辫子 扣子
    扇子 镯子 镜子 梳子 刷子 篦子 盆子 罐子 瓶子 杯子 盘子 碟子 筷子 勺子
    叉子 刀子 剪子 锤子 钳子 锯子 斧子 凿子 锥子 担子 筐子 篮子 笼子 箱子
    柜子 桌子 椅子 凳子 架子 梯子 棍子 棒子 杆子 绳子 链子 钩子 钉子 票子
    本子 册子 条子 稿子 帖子 单子 折子 曲子 谱子 戏子 班子 摊子 铺子 馆子
    庄子 厂子 窑子 炉子 灶子 锅子 炕上 窗户 门口 里头 外头 上头 下头 前头
    后头 心里 家里 屋里 手里 嘴里 眼里 夜里 这里 那里 哪里 这个 那个 哪个
    这么 那么 怎么 什么 多么 么样 咱们 我们 你们 他们 她们 人们 爷们 娘们
    哥们 姐们 先生 丈夫 媳妇 婆家 娘家 亲家 冤家 人家 东家 管家 当家 庄稼
    买卖 生意 头发 月亮 星星 太阳 日头 露水 云彩 影子 沫子 苗头 苗条 风筝
    鞭炮 炮仗 把戏 戏法 玩意 笑话 故事 规矩 讲究 见识 学问 字号 招牌 幌子
    招呼 吆喝 动静 响动 言语 话语 口气 豆腐 豆子 茄子 萝卜 葫芦 葡萄 蘑菇
    芝麻 瓜子 花生 栗子 枣子 桃子 李子 梨子 柿子 橘子 橙子 果子 种子 麦子
    稻子 谷子 高粱 棒子 糜子 包子 饺子 馒头 馄饨 面条 烧饼 点心 果子 丸子
    饼子 糊糊 粥饭 馅儿 味道 骆驼 骡子 驴子 马虎 猴子 兔子 狮子 豹子 狼崽
    虫子 蚊子 苍蝇 跳蚤 虱子 蛤蟆 燕子 鸽子 鸭子 鹞子 鸳鸯 麻雀 喜鹊 老鼠
    耗子 蝎子 蚂蚱 先生 学生 伙计 差事 差使 营生 活计 活儿 行当 行李 家伙
    家当 物件 东西 玩意 包袱 铺盖 褥子 枕头 扫帚 簸箕 笤帚 抹布 掸子 拖把
    钥匙 锁头 门栓 窗棂 台阶 栏杆 柱子 椽子 檩子 瓦片 砖头 石头 土块 泥巴
    工夫 功夫 时辰 晌午 黄昏 早上 晚上 白天 明白 清楚 糊涂 迷糊 马虎 利落
    麻利 爽快 痛快 舒服 舒坦 自在 踏实 结实 壮实 老实 厚道 地道 正经 规矩
    体面 排场 气派 架势 款式 样式 花样 名堂 名声 来历 来头 由头 缘故 原故
    告诉 知道 认识 觉得 记得 懂得 晓得 商量 打量 思量 掂量 合计 核计 盘算
    打算 打发 打扮 打点 打听 收拾 拾掇 折腾 翻腾 扑腾 折磨 糟蹋 糟踏 作践
    欺负 欺侮 招惹 招呼 张罗 张望 吆喝 叫唤 嚷嚷 嘟囔 唠叨 叨唠 念叨 嘀咕
    商量 凑合 将就 迁就 迁就 对付 答应 答理 搭理 搭讪 客套 巴结 奉承 恭维
    慢待 得罪 体谅 担待 包涵 将息 歇息 休息 消停 安生 安顿 铃铛 锄头 轱辘
    辘轳 碾子 磨盘 称呼 辈分 缘分 部分 福分 情分 本分 媒人 红娘 月老 干事
    能耐 手艺 手脚 把柄 主意 心眼 胭脂 首饰 镯子 簪子 钗子 坠子 戒指 荷包
    香囊 扇坠 算盘 算计 计较 比方 比划 指望 盼头 想头 念头 兆头 彩头 甜头
    苦头 准头 看头 听头 吃头 玩头 干头 奔头 混头 熬头 转悠 溜达 闲逛 遛弯
    蹓跶 咳嗽 喷嚏 哈欠 呼噜 力气 劲头 架子 空子 岔子 乱子 漏子 娄子 幺蛾
    困难 麻烦 累赘 拖累 连累 牵累 包袱 毛病 窟窿 亏空 交情 人情 面情 情面
    脸面 脸皮 面皮 皮实 皮匠 木头 石匠 瓦匠 漆匠 裁缝 屠户 货郎 掌柜 账房
    嚼谷 嚼用 花销 开销 房钱 店钱 脚钱 工钱 价钱 本钱 赚头 利钱 便宜 造化
    缘法 福气 闺女 婆婆 公公 丈人 丈母 大爷 大娘 大妈 大婶 大嫂 嫂子 小子
    小姐 少爷 丫鬟 仆人 佣人 下人 差人 听差 跑堂 堂倌 姑爷 姥爷 姥姥 外公
    外婆 舅妈 姨妈 姨夫 姑父 表哥 表弟 表姐 表妹 堂哥 堂弟 亲家 记号 暗号
    别扭 扭捏 忸怩 难为 难处 好处 坏处 用处 长处 短处 益处 害处 苦处 难处
    软和 暖和 热和 搀和 搅和 掺和 随和 萝卜 荸荠 菱角 藕节 荠荠 薄荷 黄芪
    模子 模样 眼色 特色 聪明 伶俐 机灵 活泛 滑溜 憨厚 忠厚 耽误 耽搁 闪失 疏忽
    大意 打扮
    """.split()
)

# Words that look like neutral-tone patterns but keep full tones.
NOT_NEUTRAL_TONE_WORDS = frozenset(
    "男子 女子 分子 原子 量子 莲子 石子 瓜子 电子 人人 虎虎 幺幺 干嘛".split()
)

_PARTICLES = "吧呢啊呐噻嘛吖嗨呐哦哒额滴哩哟喽啰耶喔诶"
_DE = "的地得"
_MEN_ZI = "们子"
_LOC = "上下里"
_LAI_QU = "来去"
_DIR = "上下进出回过起开"
_GE_PRE = "几有两半多各整每做是"
_PUNC = "：，；。？！“”‘’':,;.?!"


def _is_all_tone3(finals: List[str]) -> bool:
    return all(f[-1] == "3" for f in finals)


def _neutral(final: str) -> str:
    return final[:-1] + "5"


class ToneSandhi:
    """Rule engine; `word_finals` maps a word to FINALS_TONE3-style finals
    (needed by the merge passes to look at neighbors' tones)."""

    def __init__(self, word_finals: Callable[[str], List[str]]):
        self._word_finals = word_finals

    # ---------------- per-word tone modification ----------------

    def modified_tone(self, word: str, pos: str, finals: List[str]) -> List[str]:
        finals = self._bu(word, finals)
        finals = self._yi(word, finals)
        finals = self._neutral_tone(word, pos, finals)
        finals = self._third_tone(word, finals)
        return finals

    def _bu(self, word: str, finals: List[str]) -> List[str]:
        if len(word) == 3 and word[1] == "不":
            finals[1] = _neutral(finals[1])
            return finals
        for i, ch in enumerate(word):
            if ch == "不" and i + 1 < len(word) and finals[i + 1][-1] == "4":
                finals[i] = finals[i][:-1] + "2"
        return finals

    def _yi(self, word: str, finals: List[str]) -> List[str]:
        if "一" in word and all(c.isnumeric() for c in word if c != "一"):
            return finals
        if len(word) == 3 and word[1] == "一" and word[0] == word[2]:
            finals[1] = _neutral(finals[1])
            return finals
        if word.startswith("第一"):
            finals[1] = finals[1][:-1] + "1"
            return finals
        for i, ch in enumerate(word):
            if ch == "一" and i + 1 < len(word):
                if finals[i + 1][-1] == "4":
                    finals[i] = finals[i][:-1] + "2"
                elif word[i + 1] not in _PUNC:
                    finals[i] = finals[i][:-1] + "4"
        return finals

    def _neutral_tone(self, word: str, pos: str, finals: List[str]) -> List[str]:
        # reduplicated n/v/a syllables: 奶奶, 试试
        for j in range(1, len(word)):
            if (
                word[j] == word[j - 1]
                and pos[:1] in ("n", "v", "a")
                and word not in NOT_NEUTRAL_TONE_WORDS
            ):
                finals[j] = _neutral(finals[j])
        ge_idx = word.find("个")
        if word and word[-1] in _PARTICLES:
            finals[-1] = _neutral(finals[-1])
        elif word and word[-1] in _DE:
            finals[-1] = _neutral(finals[-1])
        elif (
            len(word) > 1
            and word[-1] in _MEN_ZI
            and pos in ("r", "n")
            and word not in NOT_NEUTRAL_TONE_WORDS
        ):
            finals[-1] = _neutral(finals[-1])
        elif len(word) > 1 and word[-1] in _LOC and pos in ("s", "l", "f"):
            finals[-1] = _neutral(finals[-1])
        elif len(word) > 1 and word[-1] in _LAI_QU and word[-2] in _DIR:
            finals[-1] = _neutral(finals[-1])
        elif (
            ge_idx >= 1 and (word[ge_idx - 1].isnumeric() or word[ge_idx - 1] in _GE_PRE)
        ) or word == "个":
            finals[ge_idx] = _neutral(finals[ge_idx])
        elif word in NEUTRAL_TONE_WORDS or word[-2:] in NEUTRAL_TONE_WORDS:
            finals[-1] = _neutral(finals[-1])

        # also check each jieba-split half of longer words
        parts = self._split_word(word)
        finals_parts = [finals[: len(parts[0])], finals[len(parts[0]):]]
        for i, part in enumerate(parts):
            if (part in NEUTRAL_TONE_WORDS or part[-2:] in NEUTRAL_TONE_WORDS) and finals_parts[i]:
                finals_parts[i][-1] = _neutral(finals_parts[i][-1])
        return finals_parts[0] + finals_parts[1]

    def _split_word(self, word: str) -> List[str]:
        import jieba

        pieces = sorted(jieba.cut_for_search(word), key=len)
        first = pieces[0] if pieces else word
        if word.find(first) == 0:
            return [first, word[len(first):]]
        return [word[: -len(first)] if first else word, first]

    def _third_tone(self, word: str, finals: List[str]) -> List[str]:
        if len(word) == 2 and _is_all_tone3(finals):
            finals[0] = finals[0][:-1] + "2"
        elif len(word) == 3:
            parts = self._split_word(word)
            if _is_all_tone3(finals):
                if len(parts[0]) == 2:
                    finals[0] = finals[0][:-1] + "2"
                    finals[1] = finals[1][:-1] + "2"
                elif len(parts[0]) == 1:
                    finals[1] = finals[1][:-1] + "2"
            else:
                fparts = [finals[: len(parts[0])], finals[len(parts[0]):]]
                for i, sub in enumerate(fparts):
                    if _is_all_tone3(sub) and len(sub) == 2:
                        sub[0] = sub[0][:-1] + "2"
                    elif (
                        i == 1
                        and not _is_all_tone3(sub)
                        and sub
                        and sub[0][-1] == "3"
                        and fparts[0]
                        and fparts[0][-1][-1] == "3"
                    ):
                        fparts[0][-1] = fparts[0][-1][:-1] + "2"
                finals = fparts[0] + fparts[1]
        elif len(word) == 4:
            out = []
            for sub in (finals[:2], finals[2:]):
                if _is_all_tone3(sub):
                    sub[0] = sub[0][:-1] + "2"
                out += sub
            finals = out
        return finals

    # ---------------- pre-segmentation merges ----------------

    def pre_merge(self, seg: Seg) -> Seg:
        seg = self._merge_bu(seg)
        try:
            seg = self._merge_yi(seg)
        except Exception:
            pass
        seg = self._merge_reduplication(seg)
        seg = self._merge_tone3_words(seg, whole_word=True)
        seg = self._merge_tone3_words(seg, whole_word=False)
        seg = self._merge_er(seg)
        return seg

    def _merge_bu(self, seg: Seg) -> Seg:
        out: Seg = []
        last = ""
        for word, pos in seg:
            if last == "不":
                word = last + word
            if word != "不":
                out.append((word, pos))
            last = word
        if last == "不":
            out.append((last, "d"))
        return out

    def _merge_yi(self, seg: Seg) -> Seg:
        out: list = []
        i = 0
        while i < len(seg):
            word, pos = seg[i]
            if (
                0 < i < len(seg) - 1
                and word == "一"
                and seg[i - 1][0] == seg[i + 1][0]
                and seg[i - 1][1] == "v"
                and out
            ):
                out[-1][0] = out[-1][0] + "一" + out[-1][0]
                i += 2
                continue
            if i >= 2 and seg[i - 1][0] == "一" and seg[i - 2][0] == word and pos == "v":
                i += 1
                continue
            out.append([word, pos])
            i += 1
        merged: list = []
        for word, pos in out:
            if merged and merged[-1][0] == "一":
                merged[-1][0] = merged[-1][0] + word
            else:
                merged.append([word, pos])
        return [(w, p) for w, p in merged]

    def _merge_reduplication(self, seg: Seg) -> Seg:
        out: list = []
        for word, pos in seg:
            if out and word == out[-1][0]:
                out[-1][0] = out[-1][0] + word
            else:
                out.append([word, pos])
        return [(w, p) for w, p in out]

    def _merge_tone3_words(self, seg: Seg, whole_word: bool) -> Seg:
        """Merge neighbors when (whole_word) both are all-tone-3, or (else)
        the boundary syllables are both tone 3."""
        finals = [self._word_finals(w) for w, _ in seg]
        out: list = []
        merged_prev = [False] * len(seg)
        for i, (word, pos) in enumerate(seg):
            can = False
            if i > 0 and finals[i - 1] and finals[i] and not merged_prev[i - 1]:
                if whole_word:
                    can = _is_all_tone3(finals[i - 1]) and _is_all_tone3(finals[i])
                else:
                    can = finals[i - 1][-1][-1] == "3" and finals[i][0][-1] == "3"
            if can and out:
                prev = seg[i - 1][0]
                if not (len(prev) == 2 and prev[0] == prev[1]) and len(prev) + len(word) <= 3:
                    out[-1][0] = out[-1][0] + word
                    merged_prev[i] = True
                    continue
            out.append([word, pos])
        return [(w, p) for w, p in out]

    def _merge_er(self, seg: Seg) -> Seg:
        out: list = []
        for i, (word, pos) in enumerate(seg):
            if i > 0 and word == "儿" and seg[i - 1][0] != "#" and out:
                out[-1][0] = out[-1][0] + word
            else:
                out.append([word, pos])
        return [(w, p) for w, p in out]
